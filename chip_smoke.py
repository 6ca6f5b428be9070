"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises, so the exit code
is non-zero and the result line is not printed:

1. device: requires CUDA, prints the card, its power limit, the torch,
   CUDA and nvcc versions; turns TF32 off;
2. build: compiles the hand-written kernels in whisper_mlx_tpu_torch/csrc;
3. kernels: each kernel against its plain PyTorch version at the main
   path's shapes (max error beside its tolerance, median times);
4. tiny model: the same weights and mel through decode() on CUDA (kernels)
   and on the CPU (plain versions);
5. main path: whisper large-v3 at full width with random bf16 weights,
   through the CLI on a synthetic 65 s WAV, then an 8-window batch timed
   through log_mel_spectrogram -> decode().

The line before the last is the card's name and power limit; the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import importlib.metadata
import importlib.util
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from whisper_mlx_tpu_torch import cli
from whisper_mlx_tpu_torch.audio.mel import N_SAMPLES, _frame_signal, log_mel_spectrogram
from whisper_mlx_tpu_torch.decoding.task import DecodingOptions, decode
from whisper_mlx_tpu_torch.decoding.tokenizer import (
    ByteLevelBPE,
    WhisperTokenizer,
    bytes_to_unicode,
)
from whisper_mlx_tpu_torch.models.whisper import (
    WHISPER_CONFIGS,
    cross_kv,
    decode_step,
    encode,
    init_kv_cache,
    init_params,
)
from whisper_mlx_tpu_torch.ops import _build
from whisper_mlx_tpu_torch.ops import decode_attention as da
from whisper_mlx_tpu_torch.ops import dense_attention as dn
from whisper_mlx_tpu_torch.ops import mel_kernel as mk
from whisper_mlx_tpu_torch.ops.kv_quant import quantize_kv
from whisper_mlx_tpu_torch.runtime.device import setup_device
from whisper_mlx_tpu_torch.runtime.serving_config import apply_asr_serving_config

MEL_TOL = 2e-4
ATTN_TOL = 2e-2  # times max(1, |ref|max)
TINY_LOGIT_TOL = 5e-2  # times max(1, |ref|max)


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    setup_device(torch.device("cuda"))
    print(f"device: {_smi()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    print("nvcc: " + nvcc.strip().splitlines()[-1])
    triton = (importlib.metadata.version("triton")
              if importlib.util.find_spec("triton") else "absent")
    print(f"triton: {triton} (none of this port's kernels uses it)")
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32} bf16_reduced="
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")


def phase_build():
    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    print(f"build: {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in str(_build.BUILD_LOG.get("stderr", "")).splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print("  ptxas: " + line.strip())


def _check(name, got, ref, tol):
    err = (got.float() - ref.float()).abs().max().item()
    print(f"  {name}: max_abs_err {err:.3e} (tol {tol:.3e})")
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs_err {err} > tol {tol}")
    return err


def phase_kernels() -> dict:
    """Each kernel against its plain version; returns the JSON rows."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    rows = {}

    # K1: one 30 s window, 3000 frames x 128 mels
    audio = torch.from_numpy(rng.standard_normal(N_SAMPLES).astype(np.float32) * 0.1).to(dev)
    frames = _frame_signal(audio, 400, 160)[:-1].contiguous()
    got = mk.log_mel_frames(frames, 128)
    ref = mk.log_mel_frames_plain(frames, 128)
    err = _check("mel 3000x128", got, ref, MEL_TOL)
    rows["mel"] = dict(
        name="log_mel", route="cuda", source="whisper_mlx_tpu_torch/csrc/mel.cu",
        replaces="whisper_mlx_tpu/ops/mel_pallas.py:61", max_abs_err=err,
        ms=_median_ms(lambda: mk.log_mel_frames(frames, 128)),
        plain_ms=_median_ms(lambda: mk.log_mel_frames_plain(frames, 128)))

    # K2: encoder self-attention, B=8 windows x 20 heads, T=1500; ragged cases
    errs = []
    for (b, h, tq, tk) in ((8, 20, 1500, 1500), (1, 3, 200, 200), (2, 3, 130, 1500)):
        q = torch.from_numpy(rng.standard_normal((b, h, tq, 64)).astype(np.float32) * 0.35)
        k = torch.from_numpy(rng.standard_normal((b, h, tk, 64)).astype(np.float32) * 0.35)
        v = torch.from_numpy(rng.standard_normal((b, h, tk, 64)).astype(np.float32))
        q, k, v = (t.to(dev, torch.bfloat16) for t in (q, k, v))
        got = dn.dense_attention(q, k, v)
        ref = dn.dense_attention_plain(q, k, v)
        tol = ATTN_TOL * max(1.0, ref.float().abs().max().item())
        errs.append(_check(f"dense_attention B={b} H={h} Tq={tq} Tk={tk}", got, ref, tol))
        if (b, tq) == (8, 1500):
            main = (q, k, v)
    rows["dense"] = dict(
        name="dense_attention", route="cuda",
        source="whisper_mlx_tpu_torch/csrc/dense_attention.cu",
        replaces="whisper_mlx_tpu/ops/dense_attention.py:91", max_abs_err=max(errs),
        ms=_median_ms(lambda: dn.dense_attention(*main), reps=10),
        plain_ms=_median_ms(lambda: dn.dense_attention_plain(*main), reps=10))

    # K3: self int8 (B=8, 20 heads, T_alloc 256) and cross int4 (Tk 1500)
    def cache(n, t, bits):
        kx = torch.from_numpy(rng.standard_normal((n, 20, t, 64)).astype(np.float32)).to(dev)
        vx = torch.from_numpy(rng.standard_normal((n, 20, t, 64)).astype(np.float32)).to(dev)
        k8, ks = quantize_kv(kx * 0.35, bits)
        v8, vs = quantize_kv(vx, bits)
        return k8, ks, v8, vs

    def query(rows_, tq):
        x = rng.standard_normal((rows_, 20, tq, 64)).astype(np.float32) * 0.35
        return torch.from_numpy(x).to(dev, torch.bfloat16)

    errs = []
    self_c = cache(8, 256, 8)
    cross_c = cache(8, 1500, 4)
    cases = [
        ("self int8 Tq=1 pos=0", query(8, 1), self_c, dict(pos=0, causal=True)),
        ("self int8 Tq=1 pos=100", query(8, 1), self_c, dict(pos=100, causal=True)),
        ("self int8 Tq=1 pos=226", query(8, 1), self_c, dict(pos=226, causal=True)),
        ("self int8 Tq=3 pos=0", query(8, 3), self_c, dict(pos=0, causal=True)),
        ("cross int4 Tq=1 g=1", query(8, 1), cross_c, dict(valid_len=1500)),
        ("cross int4 Tq=3 g=1", query(8, 3), cross_c, dict(valid_len=1500)),
        ("cross int4 Tq=1 g=5", query(40, 1), cross_c, dict(valid_len=1500, group=5)),
    ]
    for name, q, c, kw in cases:
        got = da.decode_attention(q, *c, **kw)
        ref = da.decode_attention_plain(q, *c, **kw)
        tol = ATTN_TOL * max(1.0, ref.float().abs().max().item())
        errs.append(_check(f"decode_attention {name}", got, ref, tol))
    q1 = query(8, 1)
    k_ms = (_median_ms(lambda: da.decode_attention(q1, *self_c, pos=226, causal=True))
            + _median_ms(lambda: da.decode_attention(q1, *cross_c, valid_len=1500)))
    p_ms = (_median_ms(lambda: da.decode_attention_plain(q1, *self_c, pos=226, causal=True))
            + _median_ms(lambda: da.decode_attention_plain(q1, *cross_c, valid_len=1500)))
    print(f"  decode_attention one layer's step (self pos 226 + cross): "
          f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    rows["decode"] = dict(
        name="decode_attention", route="cuda",
        source="whisper_mlx_tpu_torch/csrc/decode_attention.cu",
        replaces="whisper_mlx_tpu/ops/decode_attention.py:156", max_abs_err=max(errs),
        ms=k_ms, plain_ms=p_ms)
    torch.cuda.synchronize()
    for r in rows.values():
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")
    return rows


def _bench_tokenizer(n_vocab: int):
    """The real special-token layout over a byte-level base BPE."""
    byte_vocab = {c: i for i, c in enumerate(bytes_to_unicode().values())}
    tok = WhisperTokenizer(ByteLevelBPE(byte_vocab, []), n_base=50257,
                           num_languages=100 if n_vocab == 51866 else 99)
    assert tok.n_vocab == n_vocab, (tok.n_vocab, n_vocab)
    return tok


def phase_tiny() -> None:
    """The tiny config in the bf16 serving config: the same weights and mel
    through the kernels (CUDA) and through the plain versions (CPU)."""
    cpu, dev = torch.device("cpu"), torch.device("cuda")
    params_cpu, config = apply_asr_serving_config(
        init_params(WHISPER_CONFIGS["tiny"], seed=0), WHISPER_CONFIGS["tiny"], dev)
    print(f"tiny: dtype {config.dtype} flash {config.flash_attention} "
          f"kv {config.kv_bits} self_kv {config.self_kv_bits}")
    params_dev = {k: _to(v, dev) for k, v in params_cpu.items()}
    tok = _bench_tokenizer(config.n_vocab)
    rng = np.random.default_rng(1)
    t = np.arange(N_SAMPLES) / 16000.0
    audio = np.stack([(0.3 * np.sin(2 * np.pi * (150 + 100 * i) * t)
                       * (1 + np.sin(2 * np.pi * 2.5 * t))
                       + 0.02 * rng.standard_normal(N_SAMPLES)).astype(np.float32)
                      for i in range(2)])
    mel = torch.stack([log_mel_spectrogram(torch.from_numpy(a), config.n_mels)
                       for a in audio])

    logits = {}
    with torch.inference_mode():
        for device, params in ((cpu, params_cpu), (dev, params_dev)):
            states = encode(params, mel.to(device), config)
            init = torch.tensor([tok.sot_sequence] * 2, device=device)
            out, _ = decode_step(params, init, 0, init_kv_cache(config, 2, device, 8),
                                 cross_kv(params, states, config), config)
            logits[device.type] = out.float().cpu()
    ref = logits["cpu"]
    tol = TINY_LOGIT_TOL * max(1.0, ref.abs().max().item())
    _check("tiny prefill logits cuda vs cpu", logits["cuda"], ref, tol)

    opts = DecodingOptions(sample_len=64)
    res_cpu = decode(params_cpu, mel, tok, config, opts)
    res_dev = decode(params_dev, mel.to(dev), tok, config, opts)
    same = total = 0
    for a, b in zip(res_cpu, res_dev):
        n = max(len(a.tokens), len(b.tokens))
        same += sum(x == y for x, y in zip(a.tokens, b.tokens))
        total += n
        print(f"  tiny window: cpu {len(a.tokens)} tokens, cuda {len(b.tokens)} tokens, "
              f"first difference at {next((i for i, (x, y) in enumerate(zip(a.tokens, b.tokens)) if x != y), min(len(a.tokens), len(b.tokens)))}")
    print(f"  tiny token agreement: {same}/{total}")


def _to(node, device):
    if isinstance(node, dict):
        return {k: _to(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_to(v, device) for v in node]
    return node.to(device)


def _write_wav(path, seconds: float) -> None:
    rng = np.random.default_rng(2)
    t = np.arange(int(seconds * 16000)) / 16000.0
    x = (0.3 * np.sin(2 * np.pi * (180 + 40 * np.sin(2 * np.pi * 0.3 * t)) * t)
         * (0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t)) + 0.02 * rng.standard_normal(t.size))
    pcm = (np.clip(x, -1, 1) * 32767).astype("<i2").tobytes()
    hdr = (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVEfmt "
           + struct.pack("<IHHIIHH", 16, 1, 1, 16000, 32000, 2, 16)
           + b"data" + struct.pack("<I", len(pcm)))
    with open(path, "wb") as f:
        f.write(hdr + pcm)


def phase_main_path() -> dict:
    """large-v3 at full width (random bf16 weights): the ./run-style CLI on
    a 65 s WAV, then the 8-window batch timing. Returns launch counts."""
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "clip.wav")
        _write_wav(wav, 65.0)
        mk.LAUNCHES = dn.LAUNCHES = da.LAUNCHES = 0
        t0 = time.perf_counter()
        rc = cli.main([wav, "-f", "txt", "--output-name", "out", "-o", tmp,
                       "--model", "large-v3", "--condition-on-previous-text", "False",
                       "--hallucination-silence-threshold", "1", "--verbose", "False"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"mel": mk.LAUNCHES, "dense": dn.LAUNCHES, "decode": da.LAUNCHES}
        txt = os.path.join(tmp, "out.txt")
        assert rc == 0 and os.path.exists(txt), "CLI wrote no .txt"
        with open(txt, encoding="utf-8") as f:
            lines = f.read().splitlines()
    print(f"main path: large-v3 CLI on a 65 s WAV in {seconds:.2f} s, {len(lines)} lines "
          f"of text; launches {launches}")
    for key, n in launches.items():
        assert n > 0, f"kernel {key} was not launched on the main path"
    torch.cuda.empty_cache()
    _time_batch()
    return launches


def _time_batch() -> None:
    """8 windows through log_mel_spectrogram -> decode(), sample_len 224."""
    dev = torch.device("cuda")
    base = WHISPER_CONFIGS["large-v3"]
    params, config = apply_asr_serving_config(
        init_params(base, seed=0, device=dev, dtype=torch.bfloat16), base, dev)
    tok = _bench_tokenizer(config.n_vocab)
    batch = 8
    audio = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (batch, N_SAMPLES)).astype(np.float32) * 0.1).to(dev)
    opts = DecodingOptions(sample_len=224, without_timestamps=False)

    def pipeline():
        mel = torch.stack([log_mel_spectrogram(a, config.n_mels) for a in audio])
        return mel, decode(params, mel, tok, config, opts)

    with torch.inference_mode():
        mel, _ = pipeline()  # warm-up: cuBLAS handles, allocator
        states = encode(params, mel[:1], config)
        init = torch.tensor([tok.sot_sequence], device=dev)
        logits, _ = decode_step(params, init, 0, init_kv_cache(config, 1, dev, 8),
                                cross_kv(params, states, config), config)
        assert logits.shape == (1, 3, config.n_vocab), logits.shape
        assert torch.isfinite(logits).all(), "non-finite large-v3 logits"
    torch.cuda.synchronize()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        _, results = pipeline()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    n_tok = sum(len(r.tokens) for r in results)
    best = min(times)
    print(f"batch: large-v3 bf16 kv4/self8, {batch} windows x 30 s, sample_len 224: "
          f"{times} s (best {best:.3f} s), {n_tok} tokens, "
          f"{batch * 30.0 / best:.2f} audio-s/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _breakdown(params, config, tok, audio)


def _breakdown(params, config, tok, audio) -> None:
    """Per-layer times of the batch (host clock around synchronized work)
    and the device's busy share over decode steps (torch.profiler)."""

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    dev, batch = audio.device, audio.shape[0]
    with torch.inference_mode():
        mel, mel_ms = timed(lambda: torch.stack(
            [log_mel_spectrogram(a, config.n_mels) for a in audio]))
        states, enc_ms = timed(lambda: encode(params, mel, config))
        init = torch.tensor([tok.sot_sequence] * batch, device=dev)

        def prefill():
            xkv = cross_kv(params, states, config)
            cache = init_kv_cache(config, batch, dev, 3 + 224)
            decode_step(params, init, 0, cache, xkv, config)
            return xkv, cache

        (xkv, cache), pre_ms = timed(prefill)
        tok1 = torch.full((batch, 1), tok.timestamp_begin, device=dev)

        def steps(first, n):
            for p in range(first, first + n):
                decode_step(params, tok1, p, cache, xkv, config)

        _, steps_ms = timed(lambda: steps(3, 64))
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            _, prof_ms = timed(lambda: steps(67, 16))
    device_us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages())
    print(f"breakdown (B={batch}): mel {mel_ms:.2f} ms, encoder {enc_ms:.2f} ms, "
          f"cross_kv+prefill {pre_ms:.2f} ms, decode step {steps_ms / 64:.3f} ms "
          f"(x224 = {steps_ms / 64 * 224:.1f} ms)")
    if device_us > 0:
        print(f"decode steps under the profiler: wall {prof_ms / 16:.3f} ms/step, device "
              f"kernels {device_us / 1e3 / 16:.3f} ms/step, device idle share "
              f"{1 - device_us / 1e3 / prof_ms:.3f}")
    else:
        print("decode steps under the profiler: no device time recorded (not measured)")
    top = sorted(prof.key_averages(), key=lambda e: -getattr(e, "self_device_time_total", 0))
    for e in top[:8]:
        print(f"  {e.key[:60]:60s} device {getattr(e, 'self_device_time_total', 0) / 16:9.1f} "
              f"us/step, calls {e.count // 16}/step")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    phase_device()
    phase_build()
    rows = phase_kernels()
    phase_tiny()
    launches = phase_main_path()
    kernels = []
    for key, mod_launches in launches.items():
        row = dict(rows[key])
        row["launches"] = mod_launches
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
