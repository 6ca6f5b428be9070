"""Build the host library: python -m whisper_mlx_tpu_torch.native.build"""

import sys

from whisper_mlx_tpu_torch.native import build


def main() -> int:
    print(f"built {build()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
