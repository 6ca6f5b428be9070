"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises, so the exit code
is non-zero and the result line is not printed:

1. device: requires CUDA, prints the card, its power limit, the torch,
   CUDA and nvcc versions; turns TF32 off;
2. build: compiles the hand-written kernels in whisper_mlx_tpu_torch/csrc;
3. kernels: each kernel against its plain PyTorch version at the main
   path's shapes (max error beside its tolerance, device time per call
   with the host's launch work off the clock);
4. tiny model: the same weights and mel through decode() on CUDA (kernels)
   and on the CPU (plain versions);
5. main path: whisper large-v3 at full width with random bf16 weights,
   through the CLI on a synthetic 65 s WAV, then an 8-window batch timed
   through log_mel_spectrogram -> decode();
6. LLM kernels: the quantized matmul (K5) at the five Qwen3-32B linear
   shapes and the flash prefill (K4) against their plain versions;
7. tiny Qwen: a tiny mlx-format checkpoint written here, loaded through
   QwenModel on CUDA and on the CPU (plain versions), logits and tokens;
8. LLM main path: Qwen3-32B at full width with random packed int4 weights
   built on the card, through LLMEngine.chat, stream_generate and the
   continuous-batching engine (4 slots, 6 requests), then the timings.

The line before the last is the card's name and power limit; the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.metadata
import importlib.util
import json
import os
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from whisper_mlx_tpu_torch import cli
from whisper_mlx_tpu_torch.audio.mel import N_SAMPLES, _frame_signal, log_mel_spectrogram
from whisper_mlx_tpu_torch.decoding.llm_tokenizer import ByteFallbackTokenizer
from whisper_mlx_tpu_torch.decoding.task import DecodingOptions, decode
from whisper_mlx_tpu_torch.decoding.tokenizer import (
    ByteLevelBPE,
    WhisperTokenizer,
    bytes_to_unicode,
)
from whisper_mlx_tpu_torch.inference.generate import LLMEngine
from whisper_mlx_tpu_torch.models import qwen as qw
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
from whisper_mlx_tpu_torch.ops import flash_attention as fa
from whisper_mlx_tpu_torch.ops import mel_kernel as mk
from whisper_mlx_tpu_torch.ops import quant as tq
from whisper_mlx_tpu_torch.ops import quant_matmul as qm
from whisper_mlx_tpu_torch.ops.kv_quant import quantize_kv
from whisper_mlx_tpu_torch.runtime.device import setup_device
from whisper_mlx_tpu_torch.runtime.serving_config import apply_asr_serving_config
from whisper_mlx_tpu_torch.serving.chat import QwenModel, serving_config

MEL_TOL = 2e-4
ATTN_TOL = 2e-2  # times max(1, |ref|max)
TINY_LOGIT_TOL = 5e-2  # times max(1, |ref|max)
QMM_TOL = 1e-2  # times max(1, |ref|max): one bf16 ulp of the output
QWEN32 = qw.QWEN_CONFIGS["qwen3-32b"]


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time per call of ``fn``: ``reps`` calls back to back between
    two CUDA events, queued behind a spin kernel so that the host has
    launched them all before the first one starts and its own work (checks,
    allocation, the launch) stays off the clock. The spin grows until it
    outlasts the host's queueing; if it never does, the time includes the
    host's and a line says so."""
    for _ in range(warmup):
        fn()
    cycles = 10**8
    for _ in range(3):
        torch.cuda.synchronize()
        queued, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        queued.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        spin_ms = queued.elapsed_time(start)
        if host_ms < spin_ms:
            return start.elapsed_time(end) / reps
        cycles = int(cycles * 2 * host_ms / spin_ms)
    print(f"    (host-bound: {reps} calls took {host_ms:.1f} ms to queue, longer than a "
          f"{spin_ms:.1f} ms spin; the time below includes the host's)")
    return start.elapsed_time(end) / reps


def _kernel_us(prof) -> tuple[float, list]:
    """Device time in the profiled window, from the device's own events
    (kernels, copies): CPU operators also carry the time of the kernels
    they launch, so they are left out. -> (total us, events by time)."""
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    events.sort(key=lambda e: -e.self_device_time_total)
    return sum(e.self_device_time_total for e in events), events


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
        ms=_device_ms(lambda: mk.log_mel_frames(frames, 128)),
        plain_ms=_device_ms(lambda: mk.log_mel_frames_plain(frames, 128)))

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
        ms=_device_ms(lambda: dn.dense_attention(*main), reps=10),
        plain_ms=_device_ms(lambda: dn.dense_attention_plain(*main), reps=10))

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
    k_ms = (_device_ms(lambda: da.decode_attention(q1, *self_c, pos=226, causal=True))
            + _device_ms(lambda: da.decode_attention(q1, *cross_c, valid_len=1500)))
    p_ms = (_device_ms(lambda: da.decode_attention_plain(q1, *self_c, pos=226, causal=True))
            + _device_ms(lambda: da.decode_attention_plain(q1, *cross_c, valid_len=1500)))
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
    device_us, top = _kernel_us(prof)
    print(f"breakdown (B={batch}): mel {mel_ms:.2f} ms, encoder {enc_ms:.2f} ms, "
          f"cross_kv+prefill {pre_ms:.2f} ms, decode step {steps_ms / 64:.3f} ms "
          f"(x224 = {steps_ms / 64 * 224:.1f} ms)")
    if device_us > 0:
        print(f"decode steps under the profiler: wall {prof_ms / 16:.3f} ms/step, device "
              f"kernels {device_us / 1e3 / 16:.3f} ms/step, device idle share "
              f"{1 - device_us / 1e3 / prof_ms:.3f}")
    else:
        print("decode steps under the profiler: no device time recorded (not measured)")
    for e in top[:8]:
        print(f"  {e.key[:60]:60s} device {e.self_device_time_total / 16:9.1f} "
              f"us/step, calls {e.count // 16}/step")


# ---------------------------------------------------------------------------
# the Qwen chat LLM
# ---------------------------------------------------------------------------


# (name, N, K) of the Qwen3-32B linears that K5 runs: fused qkv, o, fused
# gate_up, down and the untied head
QWEN_LINEARS = (("qkv", 10240, 5120), ("o", 5120, 8192), ("gate_up", 51200, 5120),
                ("down", 5120, 25600), ("lm_head", 151936, 5120))


def _time_quant(name, q, m, gen, errs, m1_ms, m1_plain):
    """K5 against its plain version at one (N, K, M); returns the running
    sums of the M = 1 int4 times."""
    n, k = q.shape
    x = torch.randn((m, k), generator=gen, device=gen.device).to(torch.bfloat16)
    got = tq.quant_matmul(x, q)
    ref = qm.quant_matmul_plain(x, q.w_q, q.scales, q.biases, q.bits, q.group_size)
    tol = QMM_TOL * max(1.0, ref.float().abs().max().item())
    errs.append(_check(f"quant_matmul {name} N={n} K={k} M={m} int{q.bits}", got, ref, tol))
    del got, ref
    ms = _device_ms(lambda: tq.quant_matmul(x, q), reps=20 if m <= 4 else 5)
    plain = _device_ms(lambda: qm.quant_matmul_plain(x, q.w_q, q.scales, q.biases, q.bits,
                                                     q.group_size), reps=3, warmup=1)
    nbytes = q.w_q.numel() * 4 + q.scales.numel() * 8
    print(f"    kernel {ms:.4f} ms, plain {plain:.4f} ms, weights+affines "
          f"{nbytes / ms / 1e6:.1f} GB/s")
    if m == 1 and q.bits == 4:
        return m1_ms + ms, m1_plain + plain
    return m1_ms, m1_plain


def phase_llm_kernels() -> dict:
    """K5 at the Qwen3-32B shapes and K4 at its prefill shapes against their
    plain versions; returns the JSON rows."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    errs, m1_ms, m1_plain = [], 0.0, 0.0
    cases = [(name, n, k, 4, (1, 4, 128, 512)) for name, n, k in QWEN_LINEARS]
    cases.append(("qkv", 10240, 5120, 8, (1, 128)))
    for name, n, k, bits, m_values in cases:
        # random normal weights quantized 16384 rows at a time: each group
        # gets its own scale and bias, so their indexing is checked here
        q = tq.stack_quant([
            tq.quantize(torch.randn((min(16384, n - r), k), generator=gen, device=dev)
                        * k ** -0.5, bits) for r in range(0, n, 16384)])
        for m in m_values:
            m1_ms, m1_plain = _time_quant(name, q, m, gen, errs, m1_ms, m1_plain)
        del q
        torch.cuda.empty_cache()
    print(f"  quant_matmul one layer's linears + head at M=1 (qkv, o, gate_up, down, "
          f"lm_head): kernel {m1_ms:.4f} ms, plain {m1_plain:.4f} ms")
    rows = {"quant": dict(
        name="quant_matmul", route="cuda", source="whisper_mlx_tpu_torch/csrc/quant_matmul.cu",
        replaces="whisper_mlx_tpu/ops/quant_pallas.py:113", max_abs_err=max(errs),
        ms=m1_ms, plain_ms=m1_plain)}

    errs = []
    s = 128 ** -0.25
    for h, kvh, t, hd, causal in ((64, 8, 128, 128, True), (64, 8, 640, 128, True),
                                  (64, 8, 2048, 128, True), (20, 20, 2100, 64, False)):
        q = (torch.randn((1, h, t, hd), generator=gen, device=dev) * s).to(torch.bfloat16)
        k = (torch.randn((1, kvh, t, hd), generator=gen, device=dev) * s).to(torch.bfloat16)
        v = torch.randn((1, kvh, t, hd), generator=gen, device=dev).to(torch.bfloat16)
        got = fa.flash_attention(q, k, v, causal=causal)
        ref = fa.flash_attention_plain(q, k, v, causal=causal)
        tol = ATTN_TOL * max(1.0, ref.float().abs().max().item())
        errs.append(_check(f"flash_attention H={h} KV={kvh} T={t} hd={hd} causal={causal}",
                           got, ref, tol))
        ms = _device_ms(lambda: fa.flash_attention(q, k, v, causal=causal), reps=10)
        plain = _device_ms(lambda: fa.flash_attention_plain(q, k, v, causal=causal), reps=5)
        print(f"    kernel {ms:.4f} ms, plain {plain:.4f} ms")
        if (t, causal) == (2048, True):
            f_ms, f_plain = ms, plain
    rows["flash"] = dict(
        name="flash_attention", route="cuda", source="whisper_mlx_tpu_torch/csrc/flash_attention.cu",
        replaces="whisper_mlx_tpu/ops/flash_attention.py:72", max_abs_err=max(errs),
        ms=f_ms, plain_ms=f_plain)
    return rows


def _write_safetensors(path, tensors: dict) -> None:
    """The safetensors format by hand (the card's machine has no package):
    8-byte header length, JSON header, raw little-endian bytes."""
    codes = {np.dtype(np.uint32): "U32", np.dtype(np.float16): "F16",
             np.dtype(np.float32): "F32"}
    header, blobs, offset = {}, [], 0
    for name, arr in tensors.items():
        raw = np.ascontiguousarray(arr).tobytes()
        header[name] = {"dtype": codes[arr.dtype], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))


TINY_QWEN = dict(model_type="qwen3", vocab_size=512, hidden_size=256, intermediate_size=512,
                 num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                 head_dim=64, rope_theta=1e6, rms_norm_eps=1e-6, tie_word_embeddings=False,
                 quantization={"group_size": 64, "bits": 4})


def _write_tiny_qwen(path) -> None:
    """A tiny mlx-community-style Qwen3 checkpoint: 4-bit linears and
    embedding (U32 codes, F16 scales and biases), F32 norms."""
    rng = np.random.default_rng(4)
    c = TINY_QWEN
    d, ffn, hd = c["hidden_size"], c["intermediate_size"], c["head_dim"]
    state = {}

    def quant(prefix, n_out, n_in, std):
        w = torch.from_numpy((rng.standard_normal((n_out, n_in)) * std).astype(np.float32))
        q = tq.quantize(w, bits=4, group_size=64)
        state[f"{prefix}.weight"] = q.w_q.numpy().view(np.uint32)
        state[f"{prefix}.scales"] = q.scales.numpy().astype(np.float16)
        state[f"{prefix}.biases"] = q.biases.numpy().astype(np.float16)

    def norm(name, n):
        state[name] = (1 + 0.1 * rng.standard_normal(n)).astype(np.float32)

    for i in range(c["num_hidden_layers"]):
        pre = f"model.layers.{i}"
        for name, n_out, n_in in (("q", 4 * hd, d), ("k", 2 * hd, d), ("v", 2 * hd, d),
                                  ("o", d, 4 * hd)):
            quant(f"{pre}.self_attn.{name}_proj", n_out, n_in, n_in ** -0.5)
        for name, n_out, n_in in (("gate", ffn, d), ("up", ffn, d), ("down", d, ffn)):
            quant(f"{pre}.mlp.{name}_proj", n_out, n_in, n_in ** -0.5)
        norm(f"{pre}.self_attn.q_norm.weight", hd)
        norm(f"{pre}.self_attn.k_norm.weight", hd)
        norm(f"{pre}.input_layernorm.weight", d)
        norm(f"{pre}.post_attention_layernorm.weight", d)
    quant("model.embed_tokens", c["vocab_size"], d, 1.0)
    quant("lm_head", c["vocab_size"], d, d ** -0.5)
    norm("model.norm.weight", d)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(c, f)
    _write_safetensors(os.path.join(path, "model.safetensors"), state)


def phase_tiny_qwen() -> None:
    """A tiny mlx-format Qwen3 checkpoint through QwenModel on CUDA (K4, K5)
    and, in the same bf16 flash configuration, on the CPU (plain versions)."""
    from whisper_mlx_tpu_torch.checkpoint.qwen_loader import load_qwen

    with tempfile.TemporaryDirectory() as tmp:
        _write_tiny_qwen(tmp)
        card = QwenModel(model_path=tmp, device="cuda").engine
        params_cpu, config = load_qwen(tmp, dtype=torch.bfloat16, device="cpu")
    cpu = LLMEngine(params_cpu, serving_config(config, torch.device("cuda")),
                    ByteFallbackTokenizer())
    print(f"tiny qwen: dtype {card.config.dtype} flash {card.config.flash_attention} "
          f"linear {type(card.params['layers'][0]['attn']['qkv']['w']).__name__}")
    prompt = np.random.default_rng(5).integers(0, 263, size=(2, 40))
    logits = {}
    for label, eng in (("cpu", cpu), ("cuda", card)):
        toks = torch.from_numpy(prompt).to(eng.device)
        out, _ = qw.decode_step(eng.params, toks, 0,
                                qw.init_kv_cache(eng.config, 2, 64, eng.device), eng.config)
        logits[label] = out.float().cpu()
    ref = logits["cpu"]
    assert torch.isfinite(logits["cuda"]).all(), "non-finite tiny qwen logits"
    _check("tiny qwen prefill logits cuda vs cpu", logits["cuda"], ref,
           TINY_LOGIT_TOL * max(1.0, ref.abs().max().item()))
    text = "<|im_start|>user\nsay something<|im_end|>\n<|im_start|>assistant\n"
    a = cpu.generate(text, max_tokens=32, temperature=0.0).tokens
    b = card.generate(text, max_tokens=32, temperature=0.0).tokens
    same = sum(x == y for x, y in zip(a, b))
    first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
    print(f"  tiny qwen greedy tokens: cpu {len(a)}, cuda {len(b)}, agreement "
          f"{same}/{max(len(a), len(b))}, first difference at {first}")


class _CountingTokenizer(ByteFallbackTokenizer):
    """Byte tokenizer that records the longest id list it decoded: the
    token count of a streamed request."""

    def __init__(self):
        super().__init__()
        self.longest = 0

    def decode(self, ids):
        self.longest = max(self.longest, len(ids))
        return super().decode(ids)


def _prompt_text(rng, n: int) -> str:
    words = ["the", "model", "serves", "tokens", "quickly", "on", "one", "card", "with",
             "int4", "weights", "and", "a", "flash", "prefill"]
    out = []
    while sum(len(w) + 1 for w in out) < n:
        out.append(words[int(rng.integers(len(words)))])
    return " ".join(out)[:n]


def phase_llm_main_path() -> dict:
    """Qwen3-32B at full width (random packed int4 weights built on the card,
    bf16, flash prefill, max_context 4096): chat, stream_generate and the
    continuous-batching engine, each request checked for its token count;
    then prefill and decode rates and a profiled window. Returns launches."""
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    config = dataclasses.replace(QWEN32, dtype=torch.bfloat16, flash_attention=True)
    t0 = time.perf_counter()
    params = qw.init_random_quant_params(config, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"llm: Qwen3-32B int4 weights built on the card in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    tok = _CountingTokenizer()
    engine = LLMEngine(params, config, tok, max_context=4096)
    rng = np.random.default_rng(6)
    new = 64

    qm.LAUNCHES = fa.LAUNCHES = 0
    t0 = time.perf_counter()
    r = engine.chat([{"role": "user", "content": _prompt_text(rng, 270)}],
                    max_tokens=new, temperature=0.0)
    chat_s = time.perf_counter() - t0
    print(f"  chat: prompt {r.prompt_tokens} tokens, {r.generation_tokens} new in {chat_s:.3f} s")
    assert r.generation_tokens == new, f"chat returned {r.generation_tokens} of {new} tokens"

    tok.longest = 0
    t0 = time.perf_counter()
    text = "".join(engine.stream_generate(_prompt_text(rng, 1500), max_tokens=new,
                                          temperature=0.0))
    stream_s = time.perf_counter() - t0
    print(f"  stream_generate: prompt 1500 tokens, {tok.longest} new ({len(text)} chars) "
          f"in {stream_s:.3f} s")
    assert tok.longest == new, f"stream returned {tok.longest} of {new} tokens"

    batch = engine.continuous(4)
    t0 = time.perf_counter()
    handles = [batch.submit(_prompt_text(rng, 100 + 40 * i), max_tokens=new, temperature=0.0)
               for i in range(6)]
    counts = [len(list(h.tokens())) for h in handles]
    batch_s = time.perf_counter() - t0
    assert batch.alive, "the batch engine's worker thread died"
    assert counts == [new] * 6, f"batch requests received {counts} tokens"
    print(f"  continuous batching: 6 requests x {new} tokens on 4 slots in {batch_s:.3f} s "
          f"({6 * new / batch_s:.2f} tok/s, max occupancy {max(batch._step_occupancy)})")
    torch.cuda.synchronize()
    launches = {"quant": qm.LAUNCHES, "flash": fa.LAUNCHES}
    print(f"  launches on the LLM main path: quant_matmul {launches['quant']}, "
          f"flash_attention {launches['flash']}")
    for key, n in launches.items():
        assert n > 0, f"kernel {key} was not launched on the LLM main path"
    batch.close()
    _llm_rates(params, config)
    print(f"  llm peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def _llm_rates(params, config) -> None:
    """Prefill tok/s at the two prompt buckets; decode tok/s at B = 1 and 4
    (host clock around synchronized steps); device busy time of decode
    steps under torch.profiler."""
    dev = torch.device("cuda")

    def sync_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    for t in (384, 1536):
        toks = torch.randint(0, 256, (1, t), device=dev)
        cache = qw.init_kv_cache(config, 1, 4096, dev)
        logits, ms = sync_ms(lambda: qw.decode_step(params, toks, 0, cache, config)[0])
        assert logits.shape == (1, t, config.vocab_size), logits.shape
        assert torch.isfinite(logits).all(), "non-finite Qwen3-32B prefill logits"
        print(f"  prefill T={t}: {ms:.2f} ms, {t / ms * 1e3:.1f} tok/s")
        del logits, cache
    for rows in (1, 4):
        cache = qw.init_kv_cache(config, rows, 4096, dev)
        tok1 = torch.zeros((rows, 1), dtype=torch.long, device=dev)
        pos = 400 if rows == 1 else [400 + 37 * i for i in range(rows)]

        def steps(n):
            for i in range(n):
                p = pos + i if rows == 1 else [x + i for x in pos]
                qw.decode_step(params, tok1, p, cache, config)

        steps(2)
        _, ms = sync_ms(lambda: steps(16))
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            _, prof_ms = sync_ms(lambda: steps(8))
        device_us, top = _kernel_us(prof)
        print(f"  decode B={rows}: {ms / 16:.3f} ms/step, {rows * 16 / ms * 1e3:.2f} tok/s; "
              f"under the profiler wall {prof_ms / 8:.3f} ms/step, device kernels "
              + (f"{device_us / 1e3 / 8:.3f} ms/step" if device_us else "not measured"))
        for e in top[:6]:
            print(f"    {e.key[:60]:60s} device {e.self_device_time_total / 8:9.1f} "
                  f"us/step, calls {e.count // 8}/step")
        del cache


def _timed_phase(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    _timed_phase("device", phase_device)
    _timed_phase("build", phase_build)
    rows = _timed_phase("kernels", phase_kernels)
    _timed_phase("tiny", phase_tiny)
    launches = _timed_phase("main path", phase_main_path)
    gc.collect()
    torch.cuda.empty_cache()
    rows.update(_timed_phase("llm kernels", phase_llm_kernels))
    _timed_phase("tiny qwen", phase_tiny_qwen)
    launches.update(_timed_phase("llm main path", phase_llm_main_path))
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
