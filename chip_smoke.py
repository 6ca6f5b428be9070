"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--only phase,phase]

Phases, each printing its own lines; any failure raises, so the exit code
is non-zero and the result line is not printed:

1. device: requires CUDA, prints the card, its power limit, the torch,
   CUDA and nvcc versions; turns TF32 off;
2. build: compiles the hand-written kernels in whisper_mlx_tpu_torch/csrc;
3. kernels: each whisper kernel against its plain PyTorch version at the
   main path's shapes (max error beside its tolerance, device time per call
   with the host's launch work off the clock, the least time the card could
   take, and one PyTorch call computing the same function where one exists):
   K1 (at 3000 frames and at the 65 s CLI file's 9,500, bit-equal on a
   repeat), K2, K3 (also in speculative decoding's modes: Tq = 2 and 5,
   causal at pos 100, 226 and the cache end, and Tq = 5 over the int4
   cross cache, at 1 and 8 windows, both modes, bit-equal on a repeat),
   then the beam path's K3 integer-dot mode, K8 and K9 (K3 and the
   beam kernels L2 cold over copies of one layer's caches, K3's warm reading
   and its launcher's host cost beside; K8 row by row in both modes and
   widths at every ancestry case of K8_CHECKED and timed at each of
   K8_TIMED beside its own distinct-row bound, K9's move byte-exact at 1, 8,
   32 and 39 moved lanes and timed at 8 and 32, both bit-equal on a repeat
   and one device kernel a call); K2 also at
   the ragged edges of its 128-row q-tile and 128-key tile, in both softmax
   modes, with its TFLOP/s, share of the bound, the first (wmma) form's
   time and the launcher's host cost a call;
4. tiny model: the same weights and mel through decode() on CUDA (kernels)
   and on the CPU (plain versions), greedy and beam 3;
5. main path: whisper large-v3 at full width with random bf16 weights,
   through the CLI on a synthetic 65 s WAV (random weights fail every
   fallback threshold, so each window walks the whole ladder, cut to two
   rungs in every CLI run here: T = 0, then best_of 5 sampling at 1.0),
   then an 8-window batch timed through log_mel_spectrogram -> decode()
   (one timed run);
6. beam main path: the same model through the CLI with --beam-size 5 (the
   same two rungs: beam at T = 0, then sampling at 1.0),
   2-window beam runs of 16 steps under
   WTPU_BEAM_KV=flat, permp and permi (K9), then
   an 8-window x beam 5 batch, timed, its tokens at 64 steps beside those
   with K8's plain version (its per-step breakdown runs in phase 19 only);
7. LLM kernels: the quantized matmul (K5) at the five Qwen3-32B linear
   shapes (M = 1 L2 cold over copies of each linear, the warm reading and the
   host cost beside) and the flash prefill (K4) against their plain versions, K4 also
   at the LLM phase's prefill lengths at GQA rep 8 and rep 1, with the
   same rate, first-form and host-cost lines as K2; K5's tiled core
   (csrc/quant_tile.cuh, bf16 x, 9-512 rows) at each edge of its row
   blocks (TILED_M) on the five linears at 4 bits, qkv at 8 and whisper's
   ragged logits, each within QMM_TOL of the plain version, bit-equal on a
   repeat and one device kernel a call, then timed over one layer's four
   linears at 128, 384 and 512 rows, L2 cold, beside bf16 torch.matmul on
   the weights dequantized beforehand (a yardstick) and the bound; then
   torch._weight_int4pack_mm (the library's group-wise int4 product, weights
   packed once, MLX's affine carried over as z = b + 8 s) over the five
   linears at M = 1 and the four at 384 rows, L2 cold, each held to K5's
   plain version within QMM_TOL: the library time of the K5, K5 tiled and
   K6 rows (none where it disagrees or cannot run); then K3's GQA mode
   (the quantized Qwen cache, ROADMAP R2) against its plain version, int8
   and int4, row by row within ATTN_TOL of each row's max|ref| (fp32
   outputs within GQA_FP32_TOL) and bit-equal on a repeat, at one Qwen3-32B layer's decode step (64 query
   heads over 8 KV heads of 128; GQA_TIMED: B = 1 at positions 4,095, 226
   and 8,191, 4 slots at 37 / 700 / 2,500 / 4,000, Tq 5 at 4,095) and at
   the other widths and the launch plan's edges of GQA_CHECKED (hd 64 at
   rep 7, hd 128 at rep 5; 1 to 4,097 live keys across the plan's block
   counts, Tq 16, rep 7 at Tq 5, a first position past the cache end), one
   device kernel a call and the launcher's host cost; each GQA_TIMED shape
   timed L2 cold beside its plain version, its bound (the bytes, or the
   operations at the bf16 tensor-core rate; the reading with them at the
   fp32 rate beside it), the first form's time
   (an earlier run's) and two yardsticks at the same lengths, the fp
   cache's grouped einsum (a kv_bits = 0 step) and
   scaled_dot_product_attention(enable_gqa) on a bf16 cache;
8. tiny Qwen: a tiny mlx-format checkpoint written here, loaded through
   QwenModel on CUDA and on the CPU (plain versions), logits and tokens;
9. LLM main path: Qwen3-32B at full width with random packed int4 weights
   built on the card, through LLMEngine.chat, stream_generate and the
   continuous-batching engine (4 slots, 6 requests), then the timings
   (prefill at 128, 384, 512 and 1536 tokens);
10. LLM residency kernels: the transposed dequant-matmul (K6; packed int4,
   codes-resident, int8) and the W8A8 matmul (K7, bit-equal at every M) at
   the Qwen3-32B linear shapes against their plain versions, K7's tiled
   route held bit-equal at each edge of its row blocks (A8_TILED_M) on qkv
   and o and timed with its quantization launch over one layer's four
   linears at 128, 384 and 512 rows beside torch._int_mm and the bound, one device
   kernel a call at M <= 8 (K6 on 4-bit codes, K7) from the profiler's
   device events, the host cost a call, and K6 at ring depth 2, 4 and 8
   and at M = 4 beside K5 on the same packed weights; K6's tiled core held
   as phase 7 holds K5's (packed 4 and 8 bits, codes-resident, the
   logits) and timed over one layer (packed at 128, 384 and 512 rows,
   codes-resident at 384);
11. LLM residency main path, once under WTPU_MBT_RESIDENT=1 and once under
   WTPU_QWEN_A8=1: phase 8 under the opt-in, then Qwen3-32B (16 of its 64
   layers, full width) through chat and the continuous-batching engine,
   then the timings; under A8 also its calls by route (K7's GEMV, K7's
   tiled route, the VMEM rule's dequantize + matmul) and one profiled
   384-token prefill's device ms on K7 against the dequantization;
12. probe kernels: the dequant-matmul variants (K10a-g) at the five
   large-v3 decode-step shapes against their plain versions and against K5
   on the same weights, the batched time-minor decode attention (K11)
   against its plain version and K3, and the five ablation stages (K12);
13. probe entry points: the three probes, each run once through its main();
14. tiny 4-bit whisper: the tiny config quantized, exported as an
   mlx-format directory and loaded on the card and on the CPU;
15. whisper 4-bit main path: large-v3 at full width, bf16 weights from seed
   0 quantized on the card (int4, group 64) and written as an mlx-format
   directory, then the CLI with --model <dir> on the 65 s WAV (packed, fused
   qkv: K5), K5 and K6 against their
   plain versions at the loaded leaves' shapes, K5 summed over a decode
   step's 193 calls at 1 and 8 rows, L2 cold, beside bf16 torch.matmul on
   the leaves dequantized once (a yardstick, not the same function), 8
   windows greedy (K5), the same under WTPU_FEWROW_MBT=1 (K6),
   8 windows x beam 5 (40 rows: dequantized once, no K5/K6), a
   WTPU_DEQUANT_AT_LOAD=1 load, and an encode under WTPU_DENSE_SOFTMAX=bf16
   (K2's bf16-softmax mode);
16. batches, run only when named in --only: phase 5's dense greedy batch
   and phase 15's 4-bit packed one, two timed runs each with the per-step
   breakdown, to set two trees side by side in one call (run in turn);
17. residency_times, run only when named in --only: K6 and K7 at the
   Qwen3-32B shapes at M = 1 and 4 beside K5 and torch._int_mm, their
   device kernels and host cost a call, K6 and K5 over a large-v3 decode
   step's leaves at 8 rows, with no check of either tree's design, for the
   same use;
18. beam_times, run only when named in --only: K8 in both modes and widths
   over beam-built and all-distinct ancestries, its split mode at every
   M15_FILLS value in both modes beside the flat mode at the same ancestry,
   its per-lane layout (int8 and int4, beam-built and all-distinct), K9's
   move at 8 and 32 of 40 lanes (int32 and int64 maps), its permute and
   index_select, L2 cold, for the same use;
19. beam_batches, run only when named in --only: phase 6's dense 8-window x
   beam 5 batch, its tokens at 64 steps beside those of the same batch with
   K8's plain version, and its per-step breakdown (device ms and K8's ms a step, K8's
   ms over the whole decode), for the same use;
20. tiled_times, run only when named in --only: the tiled core (K5, K6
   packed and codes-resident) over one Qwen3-32B layer's four linears at
   128, 384 and 512 rows and over large-v3's five decode matmuls at the
   SOT step's 24 rows, L2 cold, and Qwen3-32B's prefill at 128, 384 and
   512 tokens (64 layers packed, 16 under WTPU_MBT_RESIDENT=1), for the
   same use;
21. a8_times, run only when named in --only: K7's tiled route, its x
   quantization launch and torch._int_mm over one Qwen3-32B layer's four
   linears at 128, 384 and 512 rows, K1 at 3000 and 9,500 frames, and the
   A8 prefill (16 layers) at 128, 384, 512 and 1536 tokens, for the same
   use;
22. serve, run in every whole run after phase 15: which WAV reader and DTW
   ran (the C++ library or NumPy) and whether ffmpeg and aiohttp exist;
   the tiny config card vs CPU (the batcher on three concurrent requests of
   65, 20 and 40 s with token agreement per request, the mel windows within
   MEL_TOL, prefill logits within TINY_LOGIT_TOL, the alignment pass's
   cross-attention weights within ALIGN_TOL_FP32 at fp32 on the same
   encoder states and ALIGN_TOL_BF16 end to end, with two controls that
   must exceed it, the card's weights giving the CPU's alignment path
   exactly, the words of one text, the batched transcribe with words); then
   large-v3 at full width (bf16, int4 cross, int8 self, random weights of
   seed 0): a burst of four requests of 65, 30, 20 and 65 s (8 windows,
   read by load_audio_serving as int16) through TranscriptionBatcher at the
   serving knobs' default buckets and flush, one of them streamed, with its
   windows, batches, fill, wall, audio-s/s, launches and peak memory; one
   request of 56 windows at the largest default bucket, BIG_BUCKET_SAMPLE_LEN
   tokens, with its wall and peak memory; then transcribe(batch_windows=True,
   word_timestamps=True, temperature=(0.0, 1.0)) on the 65 s file (the
   pending-only retry rung runs once), its rungs, words and stages.
   Tokens come from a four-letter-word tokenizer (_wordy_tokenizer), so
   that random weights' segments carry words;
23. spec, run in every whole run after phase 22: speculative decoding
   (ROADMAP M11). The tiny config card vs CPU: spec_decode_task with an
   identical and with a 1-layer draft (token agreement with the CPU and
   with the card's greedy, acceptance), the CLI with --draft-model on a
   12 s WAV, speculative_generate on a tiny Qwen pair and QWEN_DRAFT_PATH
   through QwenModel. Then at full width, each run with its wall, tokens,
   proposed, accepted, target and draft calls, launches of K1-K5 and peak
   memory: large-v3 (bf16 from seed 0, int4 cross, int8 self, sample_len
   SPEC_WHISPER_TOKENS = 64, cut from 224 for the time limit, no timestamps) on one 30 s window
   of noise, plain greedy, then k = 4 with the target as its own draft (the
   upper bracket) and with a random large-v3-turbo-shaped draft sharing the
   encoder (the lower bracket); Qwen3-32B packed int4 through LLMEngine.generate, 32 new
   tokens at T = 0, without a draft, with itself and with a
   Qwen2.5-0.5B-shaped packed int4 draft of seed 1. The phase's own check:
   where a speculative run's tokens first part from the plain run's, the
   plain run's gap between the two tokens' logits must be within
   SPEC_TIE_FACTOR times D, the largest verify-vs-step logit difference
   measured in the same run (teacher-forced blocks of k + 1 over the plain
   run's tokens against its own steps), and every rejection of the
   self-draft before that point must be such a near tie. Last, K3 at the
   verify's shape (one window, Tq = 5, pos 226, self + cross) beside its
   1-row reading, and K5 over Qwen3-32B's five linears at M = 5 beside
   M = 1 (checked against its plain version), L2 cold, with their bounds;
24. daemon, run in every whole run after phase 23: the port's HTTP daemon
   (ROADMAP M13) at full width, in process on a free port, every request
   over real HTTP: large-v3 behind /v1/transcribe (a burst of four requests,
   two uploads and two paths, at a raised flush so that it rides one batch,
   whose tokens must equal a TranscriptionBatcher's called directly on the
   same audios in the same arrival order; the same burst at the default
   flush, its batches counted; the stream; the sequential transcribe with
   words) and Qwen3-32B packed int4 behind
   /v1/chat (a chat, a session's SSE chat, two chats at once on one slot),
   /health and a tool; K1-K5 must each launch over the requests;
25. llm_kv, run in every whole run after phase 24: the quantized LLM KV
   cache (ROADMAP M12, WTPU_LLM_KV_BITS). A tiny Qwen3-shaped config (hd
   128, 4 KV heads) card vs CPU at kv 8 and 4 (prefill, per-row step and
   5-token block logits within TINY_LOGIT_TOL; LLMEngine's greedy tokens);
   then Qwen3-32B packed int4 at full width, 64 layers (phase 23's weights):
   LLMEngine.generate, 32 tokens at T = 0, under WTPU_LLM_KV_BITS = 0, 8 and
   4; the kv-8 engine again with K3's GQA mode replaced by its plain version
   on the card, whose tokens must equal the kernel run's up to a first
   parting that is a near tie (the plain run's gap between the two tokens
   within SPEC_TIE_FACTOR times D, the largest logit difference between the
   two over the kernel run's tokens, teacher-forced, in the same run); the
   continuous-batching engine, 4 slots and 6 requests, at kv 8; device ms a
   decode step at B = 1 and on 4 slots at a live length of about 3,500 and
   each cache's GiB, for kv 0, 8 and 4; then the daemon in process over real
   HTTP with QWEN_BATCH_SLOTS=4 and WTPU_LLM_KV_BITS=8, four overlapping
   /v1/chat requests, each answered. K3's GQA mode, K4 and K5 must launch
   over the engines' and the daemon's runs;
26. m15, run in every whole run after phase 25: the reference's last
   opt-ins (ROADMAP M15) and fault F9. K8's split mode (the shared-prefix
   beam scheme, int8) at the beam timing shape with s_fill 0, 100, 200 and
   226, at 1, 15, 16 and 17 (a 16-row tile's edges), on lanes that disagree
   below s_fill (block S reads the window's first lane's rows), both modes,
   and in clusters of 2, 3 and 8 blocks (s_fill inside a block, at 255 and
   256, at a block's edge), and its per-lane layout (decode_step(
   beam_ancestry=) over a per-lane cache, 40 lanes, T 256, int8 and int4,
   beam-built and all-distinct ancestries, agreed runs of 0, 1, 16, 17, pos
   and pos + 1 positions, lanes agreeing again after parting, runs ending
   in a cluster's later block; the flat mode on such runs too), each row by
   row within ATTN_TOL of its plain version, bit-equal on a repeat, one
   device kernel a call, the split with its overflow flag set bit-equal to
   the flat mode; each timed L2 cold beside its plain version, its bound
   and K8 flat at the same ancestry. Then large-v3 (bf16, int4 cross, int8
   self, random weights of seed 0) on 2 windows, M15_LEN steps: greedy
   under each time-major field, whose tokens must equal the time-minor
   run's bit for bit; beam 5 under WTPU_BEAM_KV=shared at read windows 64
   and 8 (where the overflow must take over), each beside the same batch
   with K8's plain version: where a window first chooses other candidates,
   the plain run's gap between them must be within SPEC_TIE_FACTOR times
   the larger of 2 D (D the largest log-softmax difference of a step's
   logits from the same step with the plain version, teacher-forced on the
   kernel run) and the score difference of the candidates both hold; beam
   5 with a time-major cross cache (K3's fp mode); decode_step with
   beam_ancestry over a per-lane cache, its logits against K8's plain
   version's within TINY_LOGIT_TOL. Last, Qwen3-32B (random packed int4,
   RESIDENCY_LAYERS layers) under WTPU_NATIVE_RESIDENT=1: every linear and
   the embedding native, 32 tokens at B = 1 (K5) beside the packed
   engine's, equal up to a near tie bounded as phase 25 bounds it, and one
   128-token prefill past the row rule (no K5) against the packed
   prefill's logits within TINY_LOGIT_TOL. K1-K5 and K8 (its split and
   per-lane modes) must launch over the phase's runs;
27. m14, run in every whole run after phase 26: multi-device parallelism
   (ROADMAP M14). First the kernels at the shapes the tp-2 ranks give
   them (_m14_shard_kernels), each against its plain version and bit-equal
   on a repeat: K2 and K3 over 10 heads, K4 at 32 query over 4 KV heads,
   K3's GQA mode over 4 KV heads (each query row within ATTN_TOL of its
   max|ref|), K5 on a rank's Qwen3-32B column and row shards at M = 1 and
   270 (within QMM_TOL). (a) This process in an NCCL group of world size 1,
   make_mesh(dp=1, tp=1): transcribe(batch_windows=True, mesh=) on phase
   22's 65 s file on large-v3 (bf16, int4 cross, int8 self, random weights of
   seed 0, BATCH_SAMPLE_LEN tokens), whose tokens must equal the meshless
   run's bit for bit. (b) Two ranks sharing the card in a gloo group (NCCL
   refuses two ranks on one card), started as processes by
   parallel/launch.py:run_ranks, each building the same weights: (b1) dp 2,
   phase 22's burst of four requests (8 windows) through
   TranscriptionBatcher(mesh=) in one bucket of 8 (rank 0 holds the queue,
   rank 1 follows), 4 windows a rank, each rank's tokens bit-equal to a
   meshless run of its own 4 windows, the 8 gathered windows' agreement
   with a meshless run of all 8 printed; (b2) tp 2 on large-v3, 2 windows,
   M14_TP_STEPS greedy steps, K2 and K3 at 10 heads a rank; (b3) tp 2 at
   Qwen3-32B's widths, packed int4, M14_QWEN_LAYERS of its 64 layers, the
   270-token prompt's prefill (K4 at 32 query heads over 4 KV heads) and
   M14_QWEN_STEPS steps (K5 on column and row shards) at kv 0 and kv 8 (K3's
   GQA mode at 4 KV heads). (b2) and (b3) are held to their meshless runs:
   the residual stream bit-equal before the first block (its error after
   each block printed: the drift's growth); the first step's logits within
   QMM_TOL x max(1, |ref|) or, where the same pair of runs with every kernel
   replaced by its plain version on the card differs by more (the net's own
   drift under tp's reordered bf16 sums, itself held within TINY_LOGIT_TOL
   x max(1, |ref|)), within SPEC_TIE_FACTOR times that; the tokens up to a
   first parting that is a
   near tie (SPEC_TIE_FACTOR x D, D the largest logit difference over the
   steps both runs take on the same tokens). Each rank's lines, launches and
   peak memory, the collectives a step and the phase's wall are printed; a
   failure in any rank fails the phase. K1-K5 and K3's GQA mode must launch
   over the main-path runs (summed over the ranks);
28. gqa_times, run only when named in --only: K3's GQA mode at each
   GQA_TIMED shape, int8 and int4, L2 cold, beside its bytes bound and bf16
   scaled_dot_product_attention(enable_gqa) at the same lengths; where the
   tree has them, the kernel's ptxas lines and the room for its clusters of
   16 and 8 blocks; for the same use as phases 16-21;
29. gqa_split, run only when named in --only: K3's GQA mode with fp32
   outputs at every GQA_TIMED and GQA_CHECKED shape, int8 and int4, beside
   two copies of the kernel built under build/ from altered sources, one
   keeping only the hi fp16 part of the query, one of the weights: the
   kernel's worst row within GQA_FP32_TOL of its max|ref|, each copy's
   past it somewhere.

Each kernel's launches in the JSON line are counted over its path's run
(phase 5 for K1-K3, 6 for K3's integer mode, K8 and K9, 9 for K4 and K5,
11 for K6 and K7, 13 for K10-K12, 15 for K2's bf16-softmax
mode), with every count set to 0 just before that run; phase 15 also
prints and checks the launches of K1, K2, K3, K5 and K6 on the 4-bit path
(the JSON line carries them as ``launches_4bit``, and K1-K3's launches over
phase 22's large-v3 runs as ``launches_serve``, K5's and K6's errors
against their plain versions at the large-v3 shapes as ``max_abs_err_4bit``,
and K5's 8-row large-v3 step as ``ms_4bit_step_8rows``; K1-K5's launches
over phase 23's speculative runs as ``launches_spec``, K3's time at the
verify's shape as ``ms_verify`` with ``bound_verify_ms`` beside its 1-row
reading ``ms_1row_1window``, K3's largest error over phase 3's speculative
cases as ``max_abs_err_spec``, and K5's at M = 5 over five Qwen3-32B linears as
``ms_m5`` with ``bound_m5_ms`` beside ``ms_m1_layer0``; K1-K5's launches over
phase 24's HTTP requests as ``launches_daemon``; K3's GQA mode's launches
over phase 25's runs as ``launches_gqa``, and K4's and K5's as
``launches_kv``; K1-K5's and K8's over phase 26's runs as ``launches_m15``, K8's
split and per-lane modes apart as ``launches_split_m15`` and
``launches_lane_m15``; K1-K5's over phase 27's sharded runs, summed over its
ranks, as ``launches_m14``, and K3's GQA mode's there as the decode row's
``launches_gqa_m14``). K8's row also carries phase 26's readings of its
two new modes: ``ms_split``, ``plain_split_ms``, ``bound_split_ms``,
``bound_split_by``, ``library_split_ms`` (null), ``max_abs_err_split``,
``flat_ms_split_shape`` (K8 flat at the same ancestry) and ``cases_split``
(every s_fill, both modes), at s_fill 100 int-dot; ``ms_lane``,
``plain_lane_ms``, ``bound_lane_ms``, ``bound_lane_by``, ``library_lane_ms``
(null), ``max_abs_err_lane`` and ``cases_lane``, at int8 beam-built.
K3's row also carries its GQA mode's phase-7 readings at
the first GQA_TIMED shape, int8: ``ms_gqa``, ``plain_gqa_ms``,
``bound_gqa_ms`` and ``bound_gqa_by`` (bf16 operations or bytes),
``bound_gqa_fp32_ops_ms`` and ``bound_gqa_fp32_ops_by`` (the operations at
the fp32 rate),
``max_abs_err_gqa`` (over every checked shape), ``library_gqa_ms`` (null: no
single PyTorch call), ``yardstick_gqa_fp_einsum_ms``,
``yardstick_gqa_sdpa_ms``, ``host_gqa_us``, and ``ms_gqa_shapes`` and
``bound_gqa_shapes`` (every timed shape and width). The K5 and K6 rows
also carry their tiled core: ``ms_tiled`` (one Qwen3-32B layer's four
linears at 384 rows, L2 cold), ``bound_tiled`` and ``bound_tiled_by``,
``yardstick_tiled_ms``, ``library_tiled_ms`` (torch._weight_int4pack_mm over the
four linears at 384 rows; K5's row also ``library_err_over_tol``, the library
call's largest error over QMM_TOL, and ``library_error`` where it could not
run) and ``launches_tiled`` (phase 9's tiled launches for
K5, phase 11's under WTPU_MBT_RESIDENT=1 for K6, each counter set to 0 with
the others); the K7 row its tiled route's ``ms_tiled`` (the four linears at
384 rows, x's quantization included), ``bound_tiled``, ``library_tiled_ms``
(torch._int_mm at the same rows), ``quantize_tiled_ms`` and
``launches_tiled`` (phase 11's under WTPU_QWEN_A8=1).

The line before the last is the card's name and power limit; the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import gc
import hashlib
import importlib.metadata
import importlib.util
import itertools
import json
import os
import pathlib
import shutil
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from whisper_mlx_tpu_torch import cli
from whisper_mlx_tpu_torch.audio.decode import load_audio_serving
from whisper_mlx_tpu_torch.audio.mel import N_SAMPLES, _frame_signal, log_mel_spectrogram
from whisper_mlx_tpu_torch.checkpoint.io_util import save_safetensors_file
from whisper_mlx_tpu_torch.checkpoint.quant_loader import export_mlx_whisper, load_mlx_whisper
from whisper_mlx_tpu_torch.decoding.llm_tokenizer import ByteFallbackTokenizer
from whisper_mlx_tpu_torch.decoding import beam as tb
from whisper_mlx_tpu_torch.decoding.task import DecodingOptions, decode, decode_setup
from whisper_mlx_tpu_torch.decoding.tokenizer import (
    ByteLevelBPE,
    WhisperTokenizer,
    bytes_to_unicode,
)
from whisper_mlx_tpu_torch.inference import transcribe as transcribe_mod
from whisper_mlx_tpu_torch.inference import word_timestamps as word_timestamps_mod
from whisper_mlx_tpu_torch.inference.generate import LLMEngine
from whisper_mlx_tpu_torch.models import qwen as qw
from whisper_mlx_tpu_torch.models import whisper as tw
from whisper_mlx_tpu_torch.models.whisper import (
    WHISPER_CONFIGS,
    beam_flat_cache,
    cross_kv,
    decode_step,
    encode,
    init_kv_cache,
    init_params,
)
from whisper_mlx_tpu_torch.ops import _build
from whisper_mlx_tpu_torch.ops import beamflat_attention as bf
from whisper_mlx_tpu_torch.ops import decode_attention as da
from whisper_mlx_tpu_torch.ops import dense_attention as dn
from whisper_mlx_tpu_torch.ops import flash_attention as fa
from whisper_mlx_tpu_torch.ops import gqa_decode_attention as gq
from whisper_mlx_tpu_torch.ops import lane_permute as lp
from whisper_mlx_tpu_torch.ops import mel_kernel as mk
from whisper_mlx_tpu_torch.ops import probe_decode_attention as pda
from whisper_mlx_tpu_torch.ops import probe_quant_matmul as pqm
from whisper_mlx_tpu_torch.ops import quant as tq
from whisper_mlx_tpu_torch.ops import quant_a8 as a8
from whisper_mlx_tpu_torch.ops import quant_matmul as qm
from whisper_mlx_tpu_torch.ops import quant_matmul_mb as mb
from whisper_mlx_tpu_torch.ops import kv_quant as kq
from whisper_mlx_tpu_torch.ops.kv_quant import quantize_kv
from whisper_mlx_tpu_torch.probes import bench_da_ablation, bench_decode_attention, bench_quant_kernel
from whisper_mlx_tpu_torch.probes.timing import profiled_us, time_us
from whisper_mlx_tpu_torch.runtime.batcher import TranscriptionBatcher
from whisper_mlx_tpu_torch.runtime.device import setup_device
from whisper_mlx_tpu_torch.runtime.serving_config import apply_asr_serving_config
from whisper_mlx_tpu_torch.serving.chat import QwenModel, serving_config

MEL_TOL = 2e-4
ATTN_TOL = 2e-2  # times max(1, |ref|max); K2, K3, K4: times each query row's max|ref|
# K3's GQA mode with fp32 outputs, times each query row's max|ref|: between
# the sound kernel's worst row and a copy's that keeps only the hi part of
# its split query or weights (phase 29 measures both)
GQA_FP32_TOL = 2e-5
TINY_LOGIT_TOL = 5e-2  # times max(1, |ref|max)
# the decode depth of the whisper batches timed whole (phases 3, 4, 15, 22
# and 24's batcher): cut from 224, a window's whole budget, to keep the
# whole run near 900 s of its 1,200 s limit
BATCH_SAMPLE_LEN = 112
# phase 22's one request of 56 windows at the largest bucket: its decode depth
# (cut from BATCH_SAMPLE_LEN for the whole run's time limit; F5 showed at the
# first steps)
BIG_BUCKET_SAMPLE_LEN = 32
QMM_TOL = 1e-2  # times max(1, |ref|max): one bf16 ulp of the output
QWEN32 = qw.QWEN_CONFIGS["qwen3-32b"]
# the card's published peaks (H100 SXM data sheet, dense, 700 W): device
# memory bytes per ms and operations per ms by type
HBM_BYTES_PER_MS = 3.35e12 / 1e3
PEAK_OPS_PER_MS = {"fp32": 67e12 / 1e3, "bf16": 989e12 / 1e3, "int8": 1979e12 / 1e3}


def _bound(nbytes: float, ops: float, kind: str) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    by_bytes = nbytes / HBM_BYTES_PER_MS
    by_ops = ops / PEAK_OPS_PER_MS[kind]
    if by_bytes >= by_ops:
        return dict(bound_ms=by_bytes, bound_by="bytes")
    return dict(bound_ms=by_ops, bound_by="operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time per call of ``fn`` in ms, with the host's own work
    (checks, allocation, the launch) off the clock: probes.timing.time_us
    says how."""
    return time_us(fn, torch.device("cuda"), reps, warmup) / 1e3


def _profiled_ms(fn, reps: int = 20) -> float:
    """Device time per call of ``fn`` from the device's own events (kernels
    and copies) under torch.profiler."""
    return profiled_us(fn, reps) / 1e3


def _cold_ms(fn, inputs: list, reps: int = 24) -> float:
    """Device time per call of ``fn(x)`` with x cycling through copies of
    one layer's inputs whose bytes together exceed the 50 MB L2, as a
    decode step finds each layer's cache: not left in L2 by the call before."""
    turn = itertools.cycle(inputs)
    return _device_ms(lambda: fn(next(turn)), reps=reps)


def _host_us(fn, reps: int = 200) -> float:
    """Host time per call of ``fn`` in us: checks, tensor maps, the launch,
    with the device kept busy behind a spin so that no call waits on it."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9))  # about a second of spin on the device
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return host


def _rate(row: dict, flops: float, host_us: float, first_form_ms: float) -> None:
    """Print a row's achieved TFLOP/s, its share of the bound and the host's
    cost a call, beside the first (wmma) form's time: a reading an earlier
    run of this script took on an H100 80GB HBM3 at 700 W before the kernel
    was redesigned, not one of this run."""
    tflops = flops / row["ms"] / 1e9
    print(f"  {row['name']}: {row['ms']:.4f} ms, {tflops:.1f} TFLOP/s, "
          f"{row['bound_ms'] / row['ms']:.1%} of the bound ({row['bound_by']}), "
          f"host {host_us:.1f} us a call (first form {first_form_ms:.4f} ms "
          "in an earlier run, not this one)")


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


def _row_err(got, ref) -> tuple[float, float]:
    """(largest error, worst row's error over that row's max|ref|)."""
    err = (got.float() - ref.float()).abs()
    row_ref = ref.float().abs().amax(-1).clamp_min(torch.finfo(torch.float32).tiny)
    return err.max().item(), (err.amax(-1) / row_ref).max().item()


def _check_rows(name, got, ref, tol: float = ATTN_TOL):
    """Hold an attention output row by row: each query row's largest error
    within ``tol`` times that row's largest |ref|. Rows that average many
    keys have small values, so one limit over the whole output would let
    them go unchecked; this limit is also within tol * max(1, |ref|).
    -> the largest error."""
    top, ratio = _row_err(got, ref)
    print(f"  {name}: max_abs_err {top:.3e}, worst row err / row max|ref| {ratio:.3e} "
          f"(tol {tol:.0e})")
    if not ratio <= tol:
        raise AssertionError(f"{name}: a row's error is {ratio} of its max|ref| > {tol}")
    return top


def phase_kernels() -> dict:
    """Each kernel against its plain version; returns the JSON rows."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    rows = {}

    # K1: one 30 s window, 3000 frames x 128 mels, then the 65 s CLI file's
    # 9,500 frames (its audio and 30 s of padding)
    audio = torch.from_numpy(rng.standard_normal(N_SAMPLES).astype(np.float32) * 0.1).to(dev)
    frames = _frame_signal(audio, 400, 160)[:-1].contiguous()
    got = mk.log_mel_frames(frames, 128)
    ref = mk.log_mel_frames_plain(frames, 128)
    err = _check("mel 3000x128", got, ref, MEL_TOL)
    if not torch.equal(got, mk.log_mel_frames(frames, 128)):
        raise AssertionError("mel 3000x128: a repeat is not bit-equal")
    mel_ms = _device_ms(lambda: mk.log_mel_frames(frames, 128))
    mel_prof = _profiled_ms(lambda: mk.log_mel_frames(frames, 128))
    print(f"  mel: {mel_ms:.4f} ms a call behind the spin, {mel_prof:.4f} ms from the "
          "profiler's device events (both device time alone)")
    long = torch.from_numpy(rng.standard_normal(9500 * 160).astype(np.float32) * 0.1).to(dev)
    frames_long = _frame_signal(long, 400, 160)[:-1].contiguous()
    got_long = mk.log_mel_frames(frames_long, 128)
    err = max(err, _check(f"mel {frames_long.shape[0]}x128", got_long,
                          mk.log_mel_frames_plain(frames_long, 128), MEL_TOL))
    if not torch.equal(got_long, mk.log_mel_frames(frames_long, 128)):
        raise AssertionError("mel 9500x128: a repeat is not bit-equal")
    _mel_times({"3000": frames, "9500": frames_long})
    rows["mel"] = dict(
        name="log_mel", route="cuda", source="whisper_mlx_tpu_torch/csrc/mel.cu",
        replaces="whisper_mlx_tpu/ops/mel_pallas.py:61", max_abs_err=err,
        ms=mel_ms,
        plain_ms=_device_ms(lambda: mk.log_mel_frames_plain(frames, 128)),
        **_mel_bound(frames), library_ms=None)

    # K2: encoder self-attention, B=8 windows x 20 heads, T=1500; ragged cases
    # at the edges of the 128-row q-tile and the 128-key tile
    errs = []
    for (b, h, tq, tk) in ((8, 20, 1500, 1500), (1, 3, 200, 200), (2, 3, 130, 1500),
                           (1, 20, 1, 1), (1, 20, 63, 1500), (1, 20, 64, 1500),
                           (1, 20, 65, 1500), (1, 20, 1500, 1500)):
        q = torch.from_numpy(rng.standard_normal((b, h, tq, 64)).astype(np.float32) * 0.35)
        k = torch.from_numpy(rng.standard_normal((b, h, tk, 64)).astype(np.float32) * 0.35)
        v = torch.from_numpy(rng.standard_normal((b, h, tk, 64)).astype(np.float32))
        q, k, v = (t.to(dev, torch.bfloat16) for t in (q, k, v))
        got = dn.dense_attention(q, k, v)
        ref = dn.dense_attention_plain(q, k, v)
        errs.append(_check_rows(f"dense_attention B={b} H={h} Tq={tq} Tk={tk}", got, ref))
        if (b, tq) == (8, 1500):
            main = (q, k, v)
        if (b, tq, tk) == (1, 65, 1500):
            # K2's bf16-softmax mode at a ragged shape
            ref = dn.dense_attention_plain(q, k, v, fast_softmax=True)
            errs.append(_check_rows(f"dense_attention bf16-softmax mode B={b} H={h} Tq={tq} "
                                    f"Tk={tk}", dn.dense_attention(q, k, v, fast_softmax=True),
                                    ref))
    rows["dense"] = dict(
        name="dense_attention", route="cuda",
        source="whisper_mlx_tpu_torch/csrc/dense_attention.cu",
        replaces="whisper_mlx_tpu/ops/dense_attention.py:91", max_abs_err=max(errs),
        ms=_device_ms(lambda: dn.dense_attention(*main), reps=10),
        plain_ms=_device_ms(lambda: dn.dense_attention_plain(*main), reps=10),
        # q, k, v, out bf16; QK^T and PV, 2 operations per multiply-add
        **_bound(4 * _nbytes(main[0]), 4 * main[0].numel() * main[1].shape[2], "bf16"),
        # q and k arrive pre-scaled by hd**-0.25, hence scale 1
        library_ms=_device_ms(lambda: F.scaled_dot_product_attention(*main, scale=1.0),
                              reps=10))
    # K2's bf16-softmax mode (WTPU_DENSE_SOFTMAX=bf16): kernel vs plain in that mode
    got = dn.dense_attention(*main, fast_softmax=True)
    ref = dn.dense_attention_plain(*main, fast_softmax=True)
    err = _check_rows("dense_attention bf16-softmax mode B=8 H=20 T=1500", got, ref)
    del got, ref
    rows["dense_fast"] = dict(
        rows["dense"], name="dense_attention_bf16_softmax", max_abs_err=err,
        ms=_device_ms(lambda: dn.dense_attention(*main, fast_softmax=True), reps=10),
        plain_ms=_device_ms(lambda: dn.dense_attention_plain(*main, fast_softmax=True), reps=10))
    flops = 4 * main[0].numel() * main[1].shape[2]
    _rate(rows["dense"], flops, _host_us(lambda: dn.dense_attention(*main)), 2.2511)
    _rate(rows["dense_fast"], flops,
          _host_us(lambda: dn.dense_attention(*main, fast_softmax=True)), 2.8988)

    # K3: self int8 (B=8, 20 heads, T_alloc 256) and cross int4 (Tk 1500)
    def cache(n, t, bits):
        return _quant_cache(rng, n, 20, t, bits)

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
        errs.append(_check_rows(f"decode_attention {name}", got, ref))
    spec_err = _spec_k3_cases(self_c, cross_c, query)
    q1 = query(8, 1)
    step = ((self_c, dict(pos=226, causal=True)), (cross_c, dict(valid_len=1500)))
    k_ms = p_ms = warm = 0.0
    for c0, kw in step:  # copies of one layer's caches, L2 cold as a decode step finds them
        layers = _layer_copies(lambda: tuple(t.clone() for t in c0), _nbytes(*c0))
        k_ms += _cold_ms(lambda c: da.decode_attention(q1, *c, **kw), layers)
        p_ms += _cold_ms(lambda c: da.decode_attention_plain(q1, *c, **kw), layers, reps=8)
        warm += _device_ms(lambda: da.decode_attention(q1, *c0, **kw))
        del layers
    host = _host_us(lambda: da.decode_attention(q1, *cross_c, valid_len=1500))
    print(f"  decode_attention one layer's step (self pos 226 + cross), L2 cold: kernel "
          f"{k_ms:.4f} ms (warm {warm:.4f} ms), plain {p_ms:.4f} ms; host {host:.1f} us a call")
    # live keys: 227 self positions (int8) and 1500 cross (int4), K and V
    # codes plus their scales, and q in / out bf16 for both calls
    live = [(227, 64 + 64 + 2 + 2), (1500, 32 + 32 + 2 + 2)]
    rows["decode"] = dict(
        name="decode_attention", route="cuda",
        source="whisper_mlx_tpu_torch/csrc/decode_attention.cu",
        replaces="whisper_mlx_tpu/ops/decode_attention.py:156", max_abs_err=max(errs),
        ms=k_ms, plain_ms=p_ms,
        **_bound(sum(8 * 20 * t * b for t, b in live) + 4 * _nbytes(q1),
                 sum(8 * 20 * t * 2 * 2 * 64 for t, _ in live), "fp32"),
        library_ms=None, max_abs_err_spec=spec_err)
    rows.update(_beam_kernels(rng, cache, query))
    torch.cuda.synchronize()
    for r in rows.values():
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), library "
              + (f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None else "none"))
    return rows


def _spec_k3_cases(self_c, cross_c, query) -> float:
    """K3 in speculative decoding's modes (ROADMAP R3) at one window a call
    (the speculative loop's grid) and at eight: the draft's 2-token sync and
    the verify's 5 rows, causal over the int8 self cache (256 positions,
    large-v3's horizon) at pos 100, 226 and where pos + Tq meets the cache
    end, and the verify's 5 rows over the int4 cross cache, with
    integer-dot off and on: row by row against the plain version, bit-equal
    on a repeat. -> the largest error."""
    errs = []
    for n in (1, 8):
        caches = [tuple(t[:n].contiguous() for t in c) for c in (self_c, cross_c)]
        cases = [(f"self int8 Tq={tq} pos={pos}", tq, caches[0], dict(pos=pos, causal=True))
                 for tq in (2, 5) for pos in (100, 226, 256 - tq)]
        cases.append(("cross int4 Tq=5", 5, caches[1], dict(valid_len=1500)))
        for int_dot in (False, True):
            for name, tq, c, kw in cases:
                q = query(n, tq)
                got = da.decode_attention(q, *c, int_dot=int_dot, **kw)
                ref = da.decode_attention_plain(q, *c, int_dot=int_dot, **kw)
                label = f"decode_attention spec {name} windows={n}{' int_dot' if int_dot else ''}"
                errs.append(_check_rows(label, got, ref))
                if not torch.equal(got, da.decode_attention(q, *c, int_dot=int_dot, **kw)):
                    raise AssertionError(f"{label}: a repeat is not bit-equal")
    return max(errs)


def _mel_bound(frames: torch.Tensor, n_mels: int = 128) -> dict:
    """K1's bound: frames, bases (400 x 208, cos and sin), filterbank (208 x
    n_mels) and output once; 201 bins x 400 samples x (re, im) FMAs and the
    201 x n_mels filterbank a frame, fp32."""
    n = frames.shape[0]
    return _bound(_nbytes(frames) + n * n_mels * 4 + (2 * 400 * 208 + 208 * n_mels) * 4,
                  n * (2 * 2 * 400 * 201 + 2 * 201 * n_mels), "fp32")


def _mel_times(cases: dict) -> None:
    """K1 and its plain version at each frame count of ``cases`` (label ->
    frames), device time a call, beside the bound."""
    for frames in cases.values():
        ms = _device_ms(lambda: mk.log_mel_frames(frames, 128))
        plain = _device_ms(lambda: mk.log_mel_frames_plain(frames, 128))
        bound = _mel_bound(frames)
        print(f"  K1 at {frames.shape[0]} frames x 128 mels: kernel {ms:.4f} ms, plain {plain:.4f} "
              f"ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}, "
              f"{bound['bound_ms'] / ms:.1%} of it)")


def _copies(tensors, n: int = 8) -> list[tuple]:
    """n copies of one layer's tensors in their own memory."""
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def _beam_ancestry(gen, n, g, t_pos):
    """An ancestry map as a beam builds it: at every position each lane
    takes a random parent's history and owns the position it writes."""
    anc = torch.arange(g, dtype=torch.int32, device=gen.device)[None, :, None].repeat(
        n, 1, t_pos)
    for t in range(1, t_pos):
        parent = torch.randint(0, g, (n, g, 1), generator=gen, device=gen.device)
        anc[:, :, :t] = anc[:, :, :t].gather(1, parent.expand(-1, -1, t))
    return anc.reshape(n * g, t_pos).contiguous()


def _k8_ancestry(kind, gen, n, g, t_pos):
    """K8's ancestry cases: "beam" as a beam builds it (about 1.05 distinct
    rows a position at beam 5), "distinct" every lane's history its own (g
    rows a position)."""
    if kind == "beam":
        return _beam_ancestry(gen, n, g, t_pos)
    return (torch.arange(n * g, dtype=torch.int32, device=gen.device) % g)[:, None].repeat(
        1, t_pos).contiguous()


def _quant_cache(rng, n, h, t, bits):
    """Random K (times 0.35) and V, quantized: (codes, scales) of each."""
    dev = torch.device("cuda")
    kx = torch.from_numpy(rng.standard_normal((n, h, t, 64)).astype(np.float32)).to(dev)
    vx = torch.from_numpy(rng.standard_normal((n, h, t, 64)).astype(np.float32)).to(dev)
    k8, ks = quantize_kv(kx * 0.35, bits)
    v8, vs = quantize_kv(vx, bits)
    return k8, ks, v8, vs


# large-v3 beam 5 on 8 windows: K8's and K9's timed shape
BEAM_N, BEAM_G, BEAM_H, BEAM_T, BEAM_POS = 8, 5, 20, 256, 226
# K8's timed cases: (code bits, integer-dot, ancestry, pos): every mode and
# width at pos 226, and the beam loop's early steps (pos 19)
K8_TIMED = [(bits, int_dot, kind, BEAM_POS) for kind in ("beam", "distinct") for bits in (8, 4)
            for int_dot in (True, False)] + [(8, True, "beam", 19)]
K9_MOVED = (8, 32)  # moved lanes of the timed moves


def _k8_label(bits, int_dot, kind, pos=BEAM_POS) -> str:
    return f"int{bits} {'int_dot' if int_dot else 'fp'} {kind} pos {pos}"


def _k9_move_map(nb, moved):
    """A move of 8 lanes (lane 5k + 1 from 5k) or 32 (every lane of a window
    of 5 from its first) of nb = 40, each from a fixed lane; int32, the
    kernel's own type, so that a call converts nothing."""
    src = torch.arange(nb, dtype=torch.int32, device="cuda")
    if moved == 8:
        src[1::5] = src[0::5]
    else:
        src = src - src % 5
    return src


def _beam_timing_inputs():
    """The timed beam kernels' inputs, the same in any tree from the same
    seeds: K8's (q, int8 and int4 flat caches, both ancestries), K9's layer
    of 40 lanes (int8 self cache, T 256) and its maps."""
    rng = np.random.default_rng(11)
    gen = torch.Generator(device="cuda").manual_seed(11)
    n, g, h, t = BEAM_N, BEAM_G, BEAM_H, BEAM_T
    q = torch.from_numpy(rng.standard_normal((n * g, h, 1, 64)).astype(np.float32) * 0.35)
    layer = list(_quant_cache(rng, n * g, h, t, 8))
    parent = torch.arange(n * g, dtype=torch.int32, device="cuda").reshape(n, g)
    parent[:, 1:] = parent[:, :1]  # lane 0 of each window spawns every child
    parent[::2, 3] = parent[::2, 3] + 3
    return dict(q=q.to("cuda", torch.bfloat16),
                caches={bits: _quant_cache(rng, n, h, t * g, bits) for bits in (8, 4)},
                anc={kind: _k8_ancestry(kind, gen, n, g, t) for kind in ("beam", "distinct")},
                layer=layer, parent=parent.reshape(-1),
                src={m: _k9_move_map(n * g, m) for m in K9_MOVED})


def _beam_kernel_times(inp) -> dict:
    """K8 (every mode, width and ancestry) and K9 (move at 8 and 32 lanes,
    from int32 and int64 maps; permute, the index_select yardstick), device
    ms a call, L2 cold over
    copies of one layer's tensors, beside one contiguous copy_ of the moved
    lanes' bytes (a yardstick for the move: the same bytes, no row map).
    Only the wrappers' public calls: any tree's kernels can be timed."""
    times = {}
    q, g = inp["q"], BEAM_G
    for bits in (8, 4):
        layers = _copies(inp["caches"][bits])
        for b, int_dot, kind, pos in K8_TIMED:
            if b == bits:
                anc = inp["anc"][kind]
                times[_k8_label(bits, int_dot, kind, pos)] = _cold_ms(
                    lambda c: bf.beamflat_attention(q, *c, anc, pos, g, int_dot=int_dot), layers)
        del layers
    layers = [list(c) for c in _copies(inp["layer"])]
    for m, src in inp["src"].items():
        times[f"move {m}"] = _cold_ms(lambda c: lp.lane_move_inplace(c, src), layers)
        # an int64 map, as the beam loop passed it before it converted its
        # maps once a step: the wrapper's conversion beside the kernel
        src64 = src.long()
        times[f"move {m} int64 map"] = _cold_ms(lambda c: lp.lane_move_inplace(c, src64),
                                                layers)
        nbytes = _nbytes(*inp["layer"]) // (BEAM_N * BEAM_G) * m
        pairs = [tuple(torch.empty(nbytes, dtype=torch.uint8, device="cuda") for _ in range(2))
                 for _ in range(8)]
        times[f"copy_ {m}"] = _cold_ms(lambda pair: pair[1].copy_(pair[0]), pairs)
        del pairs
    times["permute"] = _cold_ms(lambda c: lp.permute_lanes(c, inp["parent"]), layers)
    # one index_select per tensor of the layer (k8, ks, v8, vs)
    times["index_select"] = _cold_ms(lambda c: [t.index_select(0, inp["parent"]) for t in c],
                                     layers)
    return times


def _k8_cluster_sweep(inp) -> None:
    """K8 (int-dot int8, beam-built ancestry) at pos 19, 60 and 226, under
    each plan of 1 to 8 blocks a cluster that a span gives (launched through
    ``bf._launch`` with ``beamflat_plan(..., span=...)``): how the plan's
    span was chosen."""
    q, anc, layers = inp["q"], inp["anc"]["beam"], _copies(inp["caches"][8])
    for pos in (19, 60, BEAM_POS):
        limit, readings = pos + 1, {}
        for blocks in range(1, 9):
            plan = bf.beamflat_plan(limit, BEAM_G, span=-(-limit // blocks))
            if plan[0] not in readings:
                readings[plan[0]] = _cold_ms(lambda c: bf._launch(
                    q, *c, anc, pos, BEAM_G, True, 8, *plan), layers)
        print(f"  beamflat int8 int_dot beam pos {pos} by blocks a cluster (plan: "
              f"{bf.beamflat_plan(limit, BEAM_G)[0]}), ms: "
              f"{', '.join(f'{b}: {ms:.4f}' for b, ms in readings.items())}")


def _one_kernel(label, fn) -> None:
    """Fail unless each call of fn is one device kernel by name."""
    names, events = _device_kernels(fn)
    print(f"  {label}: {names} device kernel(s) by name, {events:g} events a call")
    if names != 1 or events > 1:
        raise AssertionError(f"{label}: {names} device kernels by name, {events} events a "
                             "call; one kernel a call expected")


# K8's checked cases: (windows, g, T, pos, ancestry): the timed shape, pos at
# 0, at the plan's span edges (255: one block a cluster, 256: two) and at
# T - 1 (447, whisper's text context); g 1, g 8 (one full tile of lanes) and
# 11 (two passes)
K8_CHECKED = [(8, 5, 256, 226, "beam"), (8, 5, 256, 226, "distinct"), (8, 5, 256, 0, "beam"),
              (8, 5, 448, 255, "beam"), (8, 5, 448, 256, "beam"), (8, 5, 448, 447, "beam"),
              (8, 1, 256, 226, "beam"), (4, 8, 256, 226, "beam"), (4, 8, 256, 226, "distinct"),
              (2, 11, 256, 226, "beam"), (2, 11, 256, 226, "distinct")]


def _beam_kernels(rng, cache, query) -> dict:
    """The beam path's kernels at large-v3 beam 5 on 8 windows: K3's
    integer-dot mode, K8 (both modes, int8 and int4, every ancestry case)
    and K9 (the permute, the move at 1, 8, 32 and 39 lanes)."""
    rows = {}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    n, g, h, t_pos, pos = BEAM_N, BEAM_G, BEAM_H, BEAM_T, BEAM_POS

    # K3 integer-dot: cross (1500 keys, int4, g = 5) and self causal (g = 1)
    errs = []
    cross_c = cache(8, 1500, 4)
    self_c = cache(40, 256, 8)
    q40 = query(40, 1)
    cases = [("cross int4 g=5 Tq=1", q40, cross_c, dict(valid_len=1500, group=5)),
             ("cross int4 g=5 Tq=3", query(40, 3), cross_c, dict(valid_len=1500, group=5)),
             ("self int8 g=1 Tq=1 pos=226", q40, self_c, dict(pos=226, causal=True)),
             ("self int8 g=1 Tq=3 pos=0", query(40, 3), self_c, dict(pos=0, causal=True))]
    for name, q, c, kw in cases:
        got = kq.attention_int8_mxu(q, *c, **kw)
        ref = da.decode_attention_plain(q, *c, int_dot=True, **kw)
        errs.append(_check_rows(f"decode_attention int_dot {name}", got, ref))
    cross_kw = dict(valid_len=1500, group=5)
    layers = _copies(cross_c)
    print(f"  decode_attention int_dot cross g=5: host "
          f"{_host_us(lambda: kq.attention_int8_mxu(q40, *cross_c, **cross_kw)):.1f} us a call")
    rows["decode_int"] = dict(
        name="decode_attention_int_dot", route="cuda",
        source="whisper_mlx_tpu_torch/csrc/decode_attention.cu",
        replaces="whisper_mlx_tpu/ops/kv_quant.py:131", max_abs_err=max(errs),
        ms=_cold_ms(lambda c: kq.attention_int8_mxu(q40, *c, **cross_kw), layers),
        plain_ms=_cold_ms(lambda c: da.decode_attention_plain(q40, *c, int_dot=True,
                                                              **cross_kw), layers, reps=8),
        # the beam step's cross call: the int4 cache once, 40 query rows
        **_bound(_nbytes(*cross_c) + 2 * _nbytes(q40), 40 * h * 1500 * 2 * 2 * 64, "int8"),
        library_ms=None)
    self_ms = _cold_ms(lambda c: kq.attention_int8_mxu(q40, *c, pos=226, causal=True),
                       _copies(self_c))
    del layers
    print(f"  decode_attention int_dot self g=1 (40 rows, pos 226): kernel {self_ms:.4f} ms")

    # K8 over the flat cache, rows t * g + k, held row by row in both modes
    # and widths at every ancestry case
    errs = []
    for n_, g_, t_, pos_, kind in K8_CHECKED:
        anc = _k8_ancestry(kind, gen, n_, g_, t_)
        q = query(n_ * g_, 1)
        plan = bf.beamflat_plan(pos_ + 1, g_)
        for bits in (8, 4):
            c = cache(n_, t_ * g_, bits)
            for int_dot in (False, True):
                got = bf.beamflat_attention(q, *c, anc, pos_, g_, int_dot=int_dot)
                ref = bf.beamflat_attention_plain(q, *c, anc, pos_, g_, int_dot=int_dot)
                errs.append(_check_rows(
                    f"beamflat_attention n={n_} g={g_} pos={pos_} {kind} (cluster {plan[0]}, "
                    f"cap {plan[1]}) int{bits} {'int_dot' if int_dot else 'fp'}", got, ref))
            del c
    inp = _beam_timing_inputs()
    q, anc = inp["q"], inp["anc"]["beam"]
    c8 = inp["caches"][8]
    for int_dot in (False, True):  # a repeat is bit-equal
        first = bf.beamflat_attention(q, *c8, anc, pos, g, int_dot=int_dot)
        if not torch.equal(first, bf.beamflat_attention(q, *c8, anc, pos, g, int_dot=int_dot)):
            raise AssertionError(f"beamflat_attention int_dot={int_dot}: a repeat differs")
        _one_kernel(f"beamflat_attention int8 int_dot={int_dot}",
                    lambda: bf.beamflat_attention(q, *c8, anc, pos, g, int_dot=int_dot))
    print(f"  beamflat_attention: repeats bit-equal; host "
          f"{_host_us(lambda: bf.beamflat_attention(q, *c8, anc, pos, g, int_dot=True)):.1f} "
          "us a call")
    times = _beam_kernel_times(inp)
    _k8_cluster_sweep(inp)
    cases = {}
    for bits, int_dot, kind, p in K8_TIMED:
        label = _k8_label(bits, int_dot, kind, p)
        needed = int(bf.beamflat_rows_needed(inp["anc"][kind], g, p).sum())
        # the distinct live rows once (codes and scales of K and V), each
        # lane's ancestry up to pos, q in and out
        cases[label] = dict(ms=times[label], distinct_rows=needed, **_bound(
            needed * h * (2 * bits * 64 // 8 + 4) + n * g * (p + 1) * 4 + 2 * _nbytes(q),
            n * g * h * (p + 1) * 2 * 2 * 64, "int8" if int_dot else "bf16"))
        print(f"  beamflat {label}: kernel {times[label]:.4f} ms, bound "
              f"{cases[label]['bound_ms']:.4f} ms ({cases[label]['bound_by']}, {needed} distinct "
              f"rows a head of {n * g * (p + 1)} lane positions), "
              f"{cases[label]['bound_ms'] / times[label]:.1%} of it")
    main = cases[_k8_label(8, True, "beam")]
    rows["beamflat"] = dict(
        name="beamflat_attention", route="cuda",
        source="whisper_mlx_tpu_torch/csrc/beamflat_attention.cu",
        replaces="whisper_mlx_tpu/ops/beamflat_attention.py:58", max_abs_err=max(errs),
        ms=main["ms"],
        plain_ms=_cold_ms(lambda c_: bf.beamflat_attention_plain(q, *c_, anc, pos, g,
                                                                 int_dot=True),
                          _copies(c8, 2), reps=8),
        bound_ms=main["bound_ms"], bound_by=main["bound_by"], library_ms=None, cases=cases)

    # K9: one layer's per-lane self cache of 40 lanes (T 256, int8)
    layer, parent = inp["layer"], inp["parent"]
    got = lp.permute_lanes(layer, parent)
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, lp.permute_lanes_plain(layer, parent)))
    _check("permute_lanes 40 lanes", torch.tensor(err), torch.tensor(0.0), 0.0)
    del got
    err_m = 0.0
    for moved in (1, 8, 32, 39):  # byte-exact, with a row of 21 bytes beside
        src = torch.arange(n * g, dtype=torch.int32, device=dev)
        if moved in K9_MOVED:
            src = inp["src"][moved]
        elif moved == 1:
            src[7] = 3
        else:
            src[1:] = 0
        odd = torch.randint(0, 256, (n * g, 3, 7), generator=gen, device=dev, dtype=torch.uint8)
        tensors = [t.clone() for t in layer] + [odd]
        want = lp.lane_move_inplace_plain([t.clone() for t in tensors], src)
        lp.lane_move_inplace(tensors, src)
        err_m = max(err_m, max(float((a.float() - b.float()).abs().max())
                               for a, b in zip(tensors, want)))
        _check(f"lane_move_inplace {moved} of 40 lanes", torch.tensor(err_m), torch.tensor(0.0),
               0.0)
        again = [t.clone() for t in layer] + [odd]
        lp.lane_move_inplace(again, src)
        if not all(torch.equal(a, b) for a, b in zip(tensors, again)):
            raise AssertionError(f"lane_move_inplace {moved} lanes: a repeat differs")
    src8 = inp["src"][8]
    moving = [t.clone() for t in layer]
    _one_kernel("lane_move_inplace 8 lanes", lambda: lp.lane_move_inplace(moving, src8))
    _one_kernel("permute_lanes", lambda: lp.permute_lanes(layer, parent))
    print(f"  lane kernels: host {_host_us(lambda: lp.lane_move_inplace(moving, src8)):.1f} us "
          f"a move, {_host_us(lambda: lp.permute_lanes(layer, parent)):.1f} us a permute")
    layers = [list(c) for c in _copies(layer)]
    rows["permute"] = dict(
        name="permute_lanes", route="cuda", source="whisper_mlx_tpu_torch/csrc/lane_permute.cu",
        replaces="whisper_mlx_tpu/ops/lane_permute.py:39", max_abs_err=err,
        ms=times["permute"],
        plain_ms=_cold_ms(lambda c: lp.permute_lanes_plain(c, parent), layers),
        **_bound(2 * _nbytes(*layer), 0, "int8"), library_ms=times["index_select"])
    move_bound = {m: _bound(2 * m * _nbytes(*layer) / (n * g), 0, "int8") for m in K9_MOVED}
    for m in K9_MOVED:
        ms, bound = times[f"move {m}"], move_bound[m]["bound_ms"]
        print(f"  lane_move_inplace {m} of 40 lanes: kernel {ms:.4f} ms, bound {bound:.4f} ms, "
              f"{bound / ms:.1%} of it (one copy_ of the same bytes {times[f'copy_ {m}']:.4f} ms); "
              f"permute "
              f"{times['permute']:.4f} ms "
              f"({rows['permute']['bound_ms'] / times['permute']:.1%} of its bound), "
              f"index_select {times['index_select']:.4f} ms")
    rows["move"] = dict(
        name="lane_move_inplace", route="cuda", source="whisper_mlx_tpu_torch/csrc/lane_permute.cu",
        replaces="whisper_mlx_tpu/ops/lane_permute.py:102", max_abs_err=err_m,
        ms=times["move 8"],
        plain_ms=_cold_ms(lambda c: lp.lane_move_inplace_plain(c, src8), layers),
        # the moved rows only: read once, written once
        **move_bound[8], library_ms=None,
        ms_32_lanes=times["move 32"], bound_ms_32_lanes=move_bound[32]["bound_ms"])
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
    _tiny_beam(params_cpu, params_dev, config, tok, mel)


def _agreement(a_results, b_results) -> tuple[int, int]:
    same = total = 0
    for a, b in zip(a_results, b_results):
        same += sum(x == y for x, y in zip(a.tokens, b.tokens))
        total += max(len(a.tokens), len(b.tokens))
    return same, total


def _tiny_beam(params_cpu, params_dev, config, tok, mel) -> None:
    """Beam 3 on the tiny config: a prefill and one flat-cache step (K3's
    integer mode, K8) card vs CPU, then decode(beam_size=3) on both."""
    cpu, dev = torch.device("cpu"), torch.device("cuda")
    cfg = dataclasses.replace(config, attn_mxu=True)
    g = 3
    logits = {}
    with torch.inference_mode():
        for device, params in ((cpu, params_cpu), (dev, params_dev)):
            states = encode(params, mel.to(device), cfg)
            init = torch.tensor([tok.sot_sequence] * (2 * g), device=device)
            cache = init_kv_cache(cfg, 2 * g, device, 8)
            xkv = cross_kv(params, states, cfg)
            pre, _ = decode_step(params, init, 0, cache, xkv, cfg, share_xkv_groups=g)
            n_init = init.shape[1]
            # every lane owns its rows, as right after the prefill
            anc = torch.arange(g, dtype=torch.int32, device=device).repeat(2)[:, None]
            step, _ = decode_step(params, init[:, -1:], n_init, beam_flat_cache(cache, g), xkv,
                                  cfg, share_xkv_groups=g,
                                  beam_ancestry=anc.repeat(1, 128).contiguous())
            logits[device.type] = torch.cat([pre, step], dim=1).float().cpu()
    ref = logits["cpu"]
    _check("tiny beam prefill + flat step logits cuda vs cpu", logits["cuda"], ref,
           TINY_LOGIT_TOL * max(1.0, ref.abs().max().item()))
    opts = DecodingOptions(sample_len=32, beam_size=3)
    res_cpu = decode(params_cpu, mel, tok, config, opts)
    res_dev = decode(params_dev, mel.to(dev), tok, config, opts)
    same, total = _agreement(res_cpu, res_dev)
    print(f"  tiny beam 3: cpu {[len(r.tokens) for r in res_cpu]} tokens, cuda "
          f"{[len(r.tokens) for r in res_dev]}; token agreement {same}/{total}")


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
    _wav_file(path, x)


def _wav_file(path, audio: np.ndarray) -> None:
    """``audio`` (16 kHz mono) as a 16-bit PCM WAV."""
    pcm = (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()
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
        # random weights fail every fallback threshold, so each window walks
        # the whole ladder, cut from the CLI's six rungs to two to keep the
        # run short: T = 0, then best_of 5 sampling at 1.0
        rc = cli.main([wav, "-f", "txt", "--output-name", "out", "-o", tmp,
                       "--model", "large-v3", "--condition-on-previous-text", "False",
                       "--hallucination-silence-threshold", "1", "--verbose", "False",
                       "--temperature-increment-on-fallback", "1.0"])
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


def _time_batch(runs: int = 1) -> None:
    """8 windows through log_mel_spectrogram -> decode(), BATCH_SAMPLE_LEN,
    ``runs`` timed runs after a warm-up (two where two trees are set side by
    side, one in the whole script)."""
    dev = torch.device("cuda")
    base = WHISPER_CONFIGS["large-v3"]
    params, config = apply_asr_serving_config(
        init_params(base, seed=0, device=dev, dtype=torch.bfloat16), base, dev)
    tok = _bench_tokenizer(config.n_vocab)
    batch = 8
    audio = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (batch, N_SAMPLES)).astype(np.float32) * 0.1).to(dev)
    opts = DecodingOptions(sample_len=BATCH_SAMPLE_LEN, without_timestamps=False)

    def pipeline(options=opts):
        mel = torch.stack([log_mel_spectrogram(a, config.n_mels) for a in audio])
        return mel, decode(params, mel, tok, config, options)

    with torch.inference_mode():
        # warm-up (cuBLAS handles, allocator): 16 steps are enough
        mel, _ = pipeline(dataclasses.replace(opts, sample_len=16))
        states = encode(params, mel[:1], config)
        init = torch.tensor([tok.sot_sequence], device=dev)
        logits, _ = decode_step(params, init, 0, init_kv_cache(config, 1, dev, 8),
                                cross_kv(params, states, config), config)
        assert logits.shape == (1, 3, config.n_vocab), logits.shape
        assert torch.isfinite(logits).all(), "non-finite large-v3 logits"
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        _, results = pipeline()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    n_tok = sum(len(r.tokens) for r in results)
    best = min(times)
    print(f"batch: large-v3 bf16 kv4/self8, {batch} windows x 30 s, sample_len {opts.sample_len}: "
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

        # 32 timed steps and 8 profiled (cut from 64 and 16 for the whole
        # run's time limit)
        _, steps_ms = timed(lambda: steps(3, 32))
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            _, prof_ms = timed(lambda: steps(35, 8))
    device_us, top = _kernel_us(prof)
    print(f"breakdown (B={batch}): mel {mel_ms:.2f} ms, encoder {enc_ms:.2f} ms, "
          f"cross_kv+prefill {pre_ms:.2f} ms, decode step {steps_ms / 32:.3f} ms "
          f"(x224 = {steps_ms / 32 * 224:.1f} ms)")
    if device_us > 0:
        print(f"decode steps under the profiler: wall {prof_ms / 8:.3f} ms/step, device "
              f"kernels {device_us / 1e3 / 8:.3f} ms/step, device idle share "
              f"{1 - device_us / 1e3 / prof_ms:.3f}")
    else:
        print("decode steps under the profiler: no device time recorded (not measured)")
    for e in top[:8]:
        print(f"  {e.key[:60]:60s} device {e.self_device_time_total / 8:9.1f} "
              f"us/step, calls {e.count // 8}/step")


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------


def _zero_counts() -> None:
    mk.LAUNCHES = dn.LAUNCHES = da.LAUNCHES = da.INT_DOT_LAUNCHES = bf.LAUNCHES = 0
    lp.PERMUTE_LAUNCHES = lp.MOVE_LAUNCHES = 0


def phase_beam_main_path() -> dict:
    """large-v3 at full width (random bf16 weights, kv4/self8): the CLI with
    --beam-size 5 on the 65 s WAV, then 2-window beam runs under each lane
    scheme (K9 launches under permp and permi). Returns the launch counts of
    the beam path's kernels; then the timed 8-window x beam 5 batch."""
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "clip.wav")
        _write_wav(wav, 65.0)
        _zero_counts()
        t0 = time.perf_counter()
        rc = cli.main([wav, "-f", "txt", "--output-name", "out", "-o", tmp,
                       "--model", "large-v3", "--condition-on-previous-text", "False",
                       "--beam-size", "5", "--verbose", "False",
                       # random weights fail every fallback threshold: the ladder
                       # is cut to two rungs (beam at T = 0, then best_of 5
                       # sampling at 1.0) to keep the run short
                       "--temperature-increment-on-fallback", "1.0"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        txt = os.path.join(tmp, "out.txt")
        assert rc == 0 and os.path.exists(txt), "CLI wrote no .txt"
        with open(txt, encoding="utf-8") as f:
            lines = f.read().splitlines()
    print(f"beam main path: large-v3 CLI --beam-size 5 on a 65 s WAV in {seconds:.2f} s, "
          f"{len(lines)} lines of text; K3 int_dot {da.INT_DOT_LAUNCHES}, K8 {bf.LAUNCHES}, "
          f"K3 fp {da.LAUNCHES} launches so far")
    dev = torch.device("cuda")
    base = WHISPER_CONFIGS["large-v3"]
    params, config = apply_asr_serving_config(
        init_params(base, seed=0, device=dev, dtype=torch.bfloat16), base, dev)
    tok = _bench_tokenizer(config.n_vocab)
    rng = np.random.default_rng(3)
    audio = torch.from_numpy(rng.standard_normal((8, N_SAMPLES)).astype(np.float32) * 0.1).to(dev)
    with torch.inference_mode():
        mel = torch.stack([log_mel_spectrogram(a, config.n_mels) for a in audio])
        states = encode(params, mel, config)
    opts = DecodingOptions(sample_len=16, beam_size=5)
    by_scheme = {}
    for scheme in ("flat", "permp", "permi"):
        os.environ["WTPU_BEAM_KV"] = scheme
        try:
            before = (lp.PERMUTE_LAUNCHES, lp.MOVE_LAUNCHES)
            by_scheme[scheme] = decode(params, states[:2], tok, config, opts,
                                       states_precomputed=True)
            torch.cuda.synchronize()
        finally:
            del os.environ["WTPU_BEAM_KV"]
        for r in by_scheme[scheme]:
            assert r.tokens and np.isfinite(r.avg_logprob), f"{scheme}: empty or non-finite"
        if scheme != "flat":
            same, total = _agreement(by_scheme["flat"], by_scheme[scheme])
            print(f"  2 windows x beam 5, sample_len 16, WTPU_BEAM_KV={scheme}: K9 launches "
                  f"permute +{lp.PERMUTE_LAUNCHES - before[0]}, move "
                  f"+{lp.MOVE_LAUNCHES - before[1]}; tokens agree with flat {same}/{total}")
    launches = {"decode_int": da.INT_DOT_LAUNCHES, "beamflat": bf.LAUNCHES,
                "permute": lp.PERMUTE_LAUNCHES, "move": lp.MOVE_LAUNCHES}
    print(f"  launches on the beam main path: {launches} (also mel {mk.LAUNCHES}, dense "
          f"{dn.LAUNCHES}, decode fp {da.LAUNCHES})")
    for key, n in launches.items():
        assert n > 0, f"kernel {key} was not launched on the beam main path"
    del states, mel
    torch.cuda.empty_cache()
    # the per-step breakdown (its profiled windows took 78-140 s) runs only
    # in phase 19: the whole run's time limit is phase 24's
    _time_beam_batch(params, config, tok, audio, breakdown=False)
    return launches


def _time_beam_batch(params, config, tok, audio, runs: int = 1, breakdown: bool = True) -> None:
    """8 windows x beam 5 through log_mel_spectrogram -> decode(),
    BATCH_SAMPLE_LEN, ``runs`` timed runs after a warm-up, then (``breakdown``) a per-step
    breakdown of beam_decode."""
    batch = audio.shape[0]
    opts = DecodingOptions(sample_len=BATCH_SAMPLE_LEN, beam_size=5, without_timestamps=False)

    def pipeline(options=opts):
        mel = torch.stack([log_mel_spectrogram(a, config.n_mels) for a in audio])
        return decode(params, mel, tok, config, options)

    with torch.inference_mode():
        pipeline(dataclasses.replace(opts, sample_len=16))  # warm-up: 16 steps are enough
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        results = pipeline()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    best = min(times)
    # the tokens' digest, to hold two trees' beam results equal
    digest = hashlib.sha256(repr([list(r.tokens) for r in results]).encode()).hexdigest()[:16]
    print(f"beam batch: large-v3 bf16 kv4/self8 int_dot, {batch} windows x beam 5 x 30 s, "
          f"sample_len {opts.sample_len}: {times} s (best {best:.3f} s), "
          f"{sum(len(r.tokens) for r in results)} tokens (digest {digest}), "
          f"{batch * 30.0 / best:.2f} audio-s/s; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # the same batch with K8's plain version in its place: the reference
    # for the kernel's tokens (random weights' near-ties can turn an ulp of
    # the softmax into another beam). Both at 64 steps: the plain version's
    # 224 steps took most of this phase's time, which the whole run's time
    # limit leaves to the speculative phase
    short = dataclasses.replace(opts, sample_len=64)
    with torch.inference_mode():
        results = pipeline(short)
    tw.beamflat_attention = bf.beamflat_attention_plain
    try:
        with torch.inference_mode():
            ref = pipeline(short)
    finally:
        tw.beamflat_attention = bf.beamflat_attention
    same, total = _agreement(results, ref)
    ref_digest = hashlib.sha256(repr([list(r.tokens) for r in ref]).encode()).hexdigest()[:16]
    windows = sum(list(a.tokens) == list(b.tokens) for a, b in zip(results, ref))
    print(f"  against K8's plain version in the same batch at 64 steps: tokens agree "
          f"{same}/{total}, {windows}/{batch} windows equal (plain digest {ref_digest})")
    if breakdown:
        _beam_breakdown(params, config, tok, audio)


def _beam_breakdown(params, config, tok, audio) -> None:
    """Per-step wall time, device busy time and kernel time by name of the
    beam loop: two beam_decode runs of 8 and 24 steps (pools never fill
    at random weights), the difference over 16 steps, without and with
    torch.profiler; then the device time and K8's over the whole 224-step
    decode (one profiled run: the late steps' window, the difference of a
    208- and a 224-step run, was cut to keep the script within its time)."""
    dev = audio.device
    beam_cfg = dataclasses.replace(config, attn_mxu=True)
    with torch.inference_mode():
        mel = torch.stack([log_mel_spectrogram(a, config.n_mels) for a in audio])
        states = encode(params, mel, config)
    opts = DecodingOptions(beam_size=5)
    setup = decode_setup(tok, opts, config, dev)
    init = torch.tensor([setup.init_tokens] * audio.shape[0], device=dev)

    def run(steps):
        return tb.beam_decode(params, states, init, setup.suppress_mask, setup.blank_mask,
                              beam_cfg, setup.filter_cfg, steps, setup.sot_index,
                              tok.no_speech, 5, 5)

    def wall(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    short, long = 8, 24
    span = long - short
    run(short)
    step_ms = (wall(long) - wall(short)) / span
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    by_name, host = {}, {}
    for steps in (short, long):
        with torch.profiler.profile(activities=activities) as prof:
            prof_ms = wall(steps)
        total, events = _kernel_us(prof)
        by_name[steps] = (prof_ms, total, {e.key: (e.self_device_time_total, e.count)
                                           for e in events})
        host[steps] = {e.key: (e.self_cpu_time_total, e.count) for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CPU}
    prof_step = (by_name[long][0] - by_name[short][0]) / span
    dev_step = (by_name[long][1] - by_name[short][1]) / 1e3 / span
    print(f"beam breakdown (8 windows x beam 5, 40 rows): decode step {step_ms:.3f} ms wall "
          f"(x224 = {step_ms * 224 / 1e3:.2f} s)")
    if dev_step > 0:
        print(f"  under the profiler: wall {prof_step:.3f} ms/step, device {dev_step:.3f} "
              f"ms/step, device idle share {1 - dev_step / prof_step:.3f}")
    else:
        print("  under the profiler: no device time recorded (not measured)")
    diff = []
    for key, (us, count) in by_name[long][2].items():
        us0, count0 = by_name[short][2].get(key, (0.0, 0))
        diff.append(((us - us0) / span, (count - count0) / span, key))
    for us, calls, key in sorted(diff, reverse=True)[:10]:
        print(f"  {key[:60]:60s} device {us:9.1f} us/step, calls {calls:.1f}/step")
    k8 = [(us, calls) for us, calls, key in diff if "beamflat" in key]
    print(f"  K8 (beamflat): {sum(us for us, _ in k8) / 1e3:.4f} ms/step over "
          f"{sum(c for _, c in k8):.1f} calls/step")
    # host side: where the step's wall time goes (CPU self time under the
    # profiler), and any host waits on the device
    diff = []
    for key, (us, count) in host[long].items():
        us0, count0 = host[short].get(key, (0.0, 0))
        diff.append(((us - us0) / span, (count - count0) / span, key))
    print(f"  host: {sum(c for _, c, _ in diff):.0f} CPU events/step")
    for us, calls, key in sorted(diff, reverse=True)[:8]:
        print(f"  {key[:60]:60s} host {us:9.1f} us/step, calls {calls:.1f}/step")
    for us, calls, key in diff:
        if "Synchronize" in key or "Memcpy" in key:
            print(f"  {key[:60]:60s} host {us:9.1f} us/step, calls {calls:.1f}/step")
    # the whole decode: device events alone (a long profiled run with the
    # host's events would be slow)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run(224)
        torch.cuda.synchronize()
    total, events = _kernel_us(prof)
    k8 = [e for e in events if "beamflat" in e.key]
    print(f"  whole decode (224 steps): device {total / 1e3:.3f} ms, K8 (beamflat) "
          f"{sum(e.self_device_time_total for e in k8) / 1e3:.4f} ms over "
          f"{sum(e.count for e in k8)} calls")


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
    if m == 1 and q.bits == 4:  # the decode reading: L2 cold, the warm one beside it
        warm = ms
        ms = _cold_ms(lambda c: tq.quant_matmul(x, c), _layer_copies(lambda: dataclasses.replace(
            q, w_q=q.w_q.clone(), scales=q.scales.clone(), biases=q.biases.clone()), nbytes))
        print(f"    L2 cold {ms:.4f} ms (warm {warm:.4f} ms); host "
              f"{_host_us(lambda: tq.quant_matmul(x, q)):.1f} us a call")
    print(f"    kernel {ms:.4f} ms, plain {plain:.4f} ms, weights+affines "
          f"{nbytes / ms / 1e6:.1f} GB/s")
    if m == 1 and q.bits == 4:
        return m1_ms + ms, m1_plain + plain, _nbytes(q.w_q, q.scales, q.biases, x) + 2 * n
    return m1_ms, m1_plain, 0


# the row counts at which the tiled core (bf16 x, 9-512 rows) is held to
# its plain version: each edge of its 16-, 32-, 64- and 128-row blocks
TILED_M = (9, 16, 24, 64, 65, 128, 255, 256, 257, 384, 511, 512)
# whisper large-v3's ragged logits (1280 -> 51866), beside the Qwen shapes
WHISPER_LOGITS = ("logits", 51866, 1280)


def _k5_plain(x, q):
    return qm.quant_matmul_plain(x, q.w_q, q.scales, q.biases, q.bits, q.group_size)


def _check_tiled(label, leaf, plain, module, gen, m_values=TILED_M) -> float:
    """The tiled core on one leaf against its plain version at each of
    ``m_values`` rows: within QMM_TOL, one tiled launch, bit-equal on a
    repeat, one device kernel a call (``_device_kernels``). Returns the
    largest error."""
    n, k = leaf.shape
    worst, kernels = 0.0, set()
    for m in m_values:
        x = torch.randn((m, k), generator=gen, device=gen.device).to(torch.bfloat16)
        before = module.TILED_LAUNCHES
        got = tq.quant_matmul(x, leaf)
        ref = plain(x, leaf)
        tol = QMM_TOL * max(1.0, ref.float().abs().max().item())
        err = (got.float() - ref.float()).abs().max().item()
        if not err <= tol:
            raise AssertionError(f"{label} N={n} K={k} M={m}: max_abs_err {err} > tol {tol}")
        if module.TILED_LAUNCHES != before + 1:
            raise AssertionError(f"{label} M={m}: not one launch of the tiled core")
        if not torch.equal(got, tq.quant_matmul(x, leaf)):
            raise AssertionError(f"{label} N={n} K={k} M={m}: a repeat is not bit-equal")
        del got, ref
        names, events = _device_kernels(lambda: tq.quant_matmul(x, leaf))
        if names != 1 or events > 1:
            raise AssertionError(f"{label} M={m}: {names} device kernels by name, {events} "
                                 "events a call; one kernel a call expected")
        kernels.add(names)
        worst = max(worst, err)
    print(f"  {label} N={n} K={k}, tiled core at M = {', '.join(map(str, m_values))}: max_abs_err "
          f"{worst:.3e} (tol {QMM_TOL:g} x max(1, |ref|)), bit-equal on a repeat, one device "
          "kernel a call")
    return worst


def _tiled_layer(gen, make_leaf, m_values=(128, 384, 512), label="K5") -> dict:
    """The tiled core over one Qwen3-32B layer's four linears (qkv, o,
    gate_up, down; random int4 g64 leaves made by ``make_leaf`` from packed
    weights) at each of ``m_values`` rows, L2 cold, beside the yardstick
    (bf16 torch.matmul on the same weights dequantized beforehand: 4x the
    bytes, not the same function) and the bound. -> {m: (kernel ms,
    yardstick ms, bound dict)}."""
    out = {m: [0.0, 0.0, 0, 0] for m in m_values}  # kernel, yardstick, bytes, ops
    for name, n, k in QWEN_LINEARS[:4]:
        q = _random_quant(gen, n, k)
        leaf = make_leaf(q)
        leaves = [getattr(leaf, f) for f in ("wqt", "scalest", "biasest")] if isinstance(
            leaf, mb.QuantTensorT) else [leaf.w_q, leaf.scales, leaf.biases]
        nbytes = _nbytes(*leaves)
        copies = _layer_copies(lambda: _mbt_copy(leaf) if isinstance(leaf, mb.QuantTensorT)
                               else dataclasses.replace(leaf, w_q=leaf.w_q.clone(),
                                                        scales=leaf.scales.clone(),
                                                        biases=leaf.biases.clone()), nbytes)
        dense = [q.dequantize(torch.bfloat16)]
        for m in m_values:
            x = torch.randn((m, k), generator=gen, device=gen.device).to(torch.bfloat16)
            ms = _cold_ms(lambda c: tq.quant_matmul(x, c), copies, reps=8)
            lib = _cold_ms(lambda w: torch.matmul(x, w.T), dense, reps=8)
            for i, v in enumerate((ms, lib, nbytes + 2 * m * (n + k), 2 * m * n * k)):
                out[m][i] += v
        del q, leaf, copies, dense
        torch.cuda.empty_cache()
    res = {}
    for m, (ms, lib, nbytes, ops) in out.items():
        bound = _bound(nbytes, ops, "bf16")
        res[m] = (ms, lib, bound)
        print(f"  {label} tiled core, one Qwen3-32B layer's four linears at M={m}, L2 cold: "
              f"{ms:.4f} ms ({ops / ms / 1e9:.1f} TFLOP/s, {bound['bound_ms'] / ms:.1%} of the "
              f"bound {bound['bound_ms']:.4f} ms by {bound['bound_by']}); yardstick, bf16 "
              f"torch.matmul on the weights dequantized beforehand: {lib:.4f} ms")
    return res


def _tiled_whisper_step(gen, m=24) -> None:
    """K5 and K6 (the same weights transposed) over whisper large-v3's five
    decode matmuls (fused qkv, o, fc1, fc2, the logits; int4 g64) at the
    SOT step's 24 rows, L2 cold, beside the yardstick and the bound."""
    sums = {"K5": 0.0, "K6": 0.0, "yardstick": 0.0}
    nbytes = ops = 0
    for k, n, _ in bench_quant_kernel.SHAPES:
        q = tq.quantize(torch.randn((n, k), generator=gen, device=gen.device) * 0.02, 4, 64)
        x = torch.randn((m, k), generator=gen, device=gen.device).to(torch.bfloat16)
        size = _nbytes(q.w_q, q.scales, q.biases)
        packed = _layer_copies(lambda: dataclasses.replace(
            q, w_q=q.w_q.clone(), scales=q.scales.clone(), biases=q.biases.clone()), size)
        qt = mb.transpose_quant(q)
        sums["K5"] += _cold_ms(lambda c: tq.quant_matmul(x, c), packed)
        sums["K6"] += _cold_ms(lambda c: tq.quant_matmul(x, c), _layer_copies(
            lambda: _mbt_copy(qt), _nbytes(qt.wqt, qt.scalest, qt.biasest)))
        sums["yardstick"] += _cold_ms(lambda w: torch.matmul(x, w.T),
                                      [c.dequantize(torch.bfloat16) for c in packed])
        nbytes += size + 2 * m * (n + k)
        ops += 2 * m * n * k
        del packed, qt
        torch.cuda.empty_cache()
    bound = _bound(nbytes, ops, "bf16")
    print(f"  tiled core over large-v3's five decode matmuls at {m} rows (the SOT step), L2 cold: "
          f"K5 {sums['K5']:.4f} ms, K6 {sums['K6']:.4f} ms; bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}); yardstick, bf16 torch.matmul on the weights dequantized "
          f"beforehand: {sums['yardstick']:.4f} ms")


# torch._weight_int4pack_mm's times on the Qwen3-32B linears (phase 7), for
# the K5, K5 tiled and K6 rows' library_ms
_INT4PACK: dict = {}


def _int4pack(q):
    """MLX's affine ``w = q s + b`` (4 bits) packed for
    ``torch._weight_int4pack_mm``, whose tinygemm form is ``(q - 8) s + z``:
    ``z = b + 8 s``; codes two a byte, the even k in the high nibble, packed
    once by ``torch._convert_weight_to_int4pack``; scales and zeros as
    (groups, N, 2) bf16. -> (packed weights, scales and zeros)."""
    codes = tq.unpack(q.w_q, 4)
    w = torch._convert_weight_to_int4pack(
        ((codes[:, ::2] << 4) | codes[:, 1::2]).to(torch.uint8), 8)
    del codes
    sz = torch.stack([q.scales, q.biases + 8 * q.scales], dim=-1)
    return w, sz.transpose(0, 1).contiguous().to(torch.bfloat16)


def _int4pack_library(gen) -> dict:
    """``torch._weight_int4pack_mm`` (one PyTorch call: the group-wise int4
    product, weights packed once) over Qwen3-32B's five linears at M = 1 and
    one layer's four at 384 rows, L2 cold, each held to K5's plain version
    within QMM_TOL. Nothing in the port routes to it. -> {"m1": five
    linears' ms, "m1_four": the first four's, "m384": four at 384 rows,
    "err": the largest error over tol, "error": why it could not run}."""
    out = {"m1": 0.0, "m1_four": 0.0, "m384": 0.0, "err": 0.0, "error": None}
    try:
        for name, n, k in QWEN_LINEARS:
            q = _random_quant(gen, n, k)
            w, sz = _int4pack(q)
            copies = _layer_copies(lambda: (w.clone(), sz.clone()), _nbytes(w, sz))
            for m in ((1, 384) if name != "lm_head" else (1,)):
                x = torch.randn((m, k), generator=gen, device=gen.device).to(torch.bfloat16)
                got = torch._weight_int4pack_mm(x, w, q.group_size, sz)
                ref = _k5_plain(x, q)
                tol = QMM_TOL * max(1.0, ref.float().abs().max().item())
                err = (got.float() - ref.float()).abs().max().item()
                out["err"] = max(out["err"], err / tol)
                ms = _cold_ms(lambda c: torch._weight_int4pack_mm(x, c[0], q.group_size, c[1]),
                              copies, reps=8 if m > 1 else 24)
                print(f"    torch._weight_int4pack_mm {name} N={n} K={k} M={m}: {ms:.4f} ms "
                      f"L2 cold, max_abs_err {err:.3e} against K5's plain version (tol "
                      f"{tol:.3e})")
                out["m384" if m > 1 else "m1"] += ms
                if m == 1 and name != "lm_head":
                    out["m1_four"] += ms
                del got, ref
            del q, w, sz, copies
            torch.cuda.empty_cache()
    except (RuntimeError, AttributeError, TypeError) as exc:
        # a partial sum is no library time
        out.update(m1=None, m1_four=None, m384=None, error=f"{type(exc).__name__}: {exc}")
        print(f"  torch._weight_int4pack_mm could not run: {out['error']}")
        return out
    within = out["err"] <= 1.0
    print(f"  torch._weight_int4pack_mm: five linears at M=1 {out['m1']:.4f} ms, the four "
          f"{out['m1_four']:.4f} ms, four at 384 rows {out['m384']:.4f} ms; largest error "
          f"{out['err']:.3f} x QMM_TOL ({'within' if within else 'NOT within: no library time'})")
    if not within:  # not the same function at this tolerance
        out.update(m1=None, m1_four=None, m384=None)
    return out


def phase_llm_kernels() -> dict:
    """K5 at the Qwen3-32B shapes and K4 at its prefill shapes against their
    plain versions; K5's tiled core at every edge of its row blocks on the
    five Qwen3-32B linears (4 and 8 bits) and whisper's ragged logits, and
    timed over one layer's four linears; returns the JSON rows."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    errs, m1_ms, m1_plain, m1_bytes = [], 0.0, 0.0, 0
    cases = [(name, n, k, 4, (1, 4, 128, 512)) for name, n, k in QWEN_LINEARS]
    cases.append(("qkv", 10240, 5120, 8, (1, 128)))
    for name, n, k, bits, m_values in cases:
        # random normal weights quantized 16384 rows at a time: each group
        # gets its own scale and bias, so their indexing is checked here
        q = tq.stack_quant([
            tq.quantize(torch.randn((min(16384, n - r), k), generator=gen, device=dev)
                        * k ** -0.5, bits) for r in range(0, n, 16384)])
        for m in m_values:
            m1_ms, m1_plain, nbytes = _time_quant(name, q, m, gen, errs, m1_ms, m1_plain)
            m1_bytes += nbytes
        if bits == 4 or name == "qkv":
            errs.append(_check_tiled(f"quant_matmul {name} int{bits}", q, _k5_plain, qm, gen))
        del q
        torch.cuda.empty_cache()
    _, n, k = WHISPER_LOGITS
    errs.append(_check_tiled("quant_matmul whisper logits int4", _random_quant(gen, n, k),
                             _k5_plain, qm, gen))
    tiled = _tiled_layer(gen, lambda q: q)
    print(f"  quant_matmul one layer's linears + head at M=1 (qkv, o, gate_up, down, "
          f"lm_head): kernel {m1_ms:.4f} ms, plain {m1_plain:.4f} ms")
    _INT4PACK.update(_int4pack_library(gen))
    lib = dict(library_err_over_tol=_INT4PACK["err"])
    if _INT4PACK["error"]:
        lib["library_error"] = _INT4PACK["error"]
    rows = {"quant": dict(
        name="quant_matmul", route="cuda", source="whisper_mlx_tpu_torch/csrc/quant_matmul.cu",
        replaces="whisper_mlx_tpu/ops/quant_pallas.py:113", max_abs_err=max(errs),
        ms=m1_ms, plain_ms=m1_plain,
        # codes, scales and biases of the five linears once, x in, y out
        **_bound(m1_bytes, 2 * sum(n * k for _, n, k in QWEN_LINEARS), "bf16"),
        library_ms=_INT4PACK["m1"], library_tiled_ms=_INT4PACK["m384"], **lib,
        **_tiled_keys(tiled))}

    errs = []
    s = 128 ** -0.25
    # the LLM phase's prefill lengths (not multiples of the tile) at GQA rep 8
    # and rep 1, whisper's non-causal hd 64 over more than 2048 keys, and the
    # speculative phase's Qwen2.5-0.5B-shaped draft (14 q / 2 KV heads of 64)
    for h, kvh, t, hd, causal in ((64, 8, 128, 128, True), (64, 8, 640, 128, True),
                                  (64, 8, 2048, 128, True), (20, 20, 2100, 64, False),
                                  (64, 8, 295, 128, True), (64, 8, 384, 128, True),
                                  (64, 8, 1536, 128, True), (8, 8, 295, 128, True),
                                  (8, 8, 1536, 128, True), (14, 2, 300, 64, True)):
        q = (torch.randn((1, h, t, hd), generator=gen, device=dev) * s).to(torch.bfloat16)
        k = (torch.randn((1, kvh, t, hd), generator=gen, device=dev) * s).to(torch.bfloat16)
        v = torch.randn((1, kvh, t, hd), generator=gen, device=dev).to(torch.bfloat16)
        got = fa.flash_attention(q, k, v, causal=causal)
        ref = fa.flash_attention_plain(q, k, v, causal=causal)
        errs.append(_check_rows(f"flash_attention H={h} KV={kvh} T={t} hd={hd} causal={causal}",
                                got, ref))
        ms = _device_ms(lambda: fa.flash_attention(q, k, v, causal=causal), reps=10)
        plain = _device_ms(lambda: fa.flash_attention_plain(q, k, v, causal=causal), reps=5)
        print(f"    kernel {ms:.4f} ms, plain {plain:.4f} ms")
        if (t, causal) == (2048, True):
            # q, k, v, out bf16; the causal half of QK^T and PV
            flops = 2 * 2 * h * hd * t * (t + 1) / 2
            f = dict(ms=ms, plain_ms=plain,
                     **_bound(2 * _nbytes(q) + 2 * _nbytes(k), flops, "bf16"),
                     library_ms=_device_ms(lambda: F.scaled_dot_product_attention(
                         q, k, v, is_causal=True, scale=1.0, enable_gqa=True), reps=10))
            host = _host_us(lambda: fa.flash_attention(q, k, v, causal=True))
    rows["flash"] = dict(
        name="flash_attention", route="cuda", source="whisper_mlx_tpu_torch/csrc/flash_attention.cu",
        replaces="whisper_mlx_tpu/ops/flash_attention.py:72", max_abs_err=max(errs), **f)
    _rate(rows["flash"], flops, host, 1.4432)
    rows["gqa"] = _gqa_kernels(gen)
    return rows


# K3's GQA mode over the quantized Qwen cache (ROADMAP R2): one Qwen3-32B
# layer's decode step, 64 query heads over 8 KV heads of 128, at (label, first
# positions, Tq, cache length); the first is the JSON line's headline shape
GQA_TIMED = (("B 1, pos 4,095", [4095], 1, 4096), ("B 1, pos 226", [226], 1, 4096),
             ("B 1, pos 8,191", [8191], 1, 8192),
             ("4 slots, pos 37 / 700 / 2,500 / 4,000", [37, 700, 2500, 4000], 1, 4096),
             ("Tq 5, pos 4,095", [4095], 5, 8192))
# the port's other widths, checked only: hd 64 at rep 7 (Qwen2.5-0.5B's 14
# over 2), hd 128 at rep 5 (Qwen2.5-14B's 40 over 8); then the edges of the
# launch plan (ops/gqa_decode_attention.py:gqa_plan): 1 live key, 64 / 65 (1
# block a head to 2), 255 / 256 / 257, 960 / 961 at 2 KV heads (a held
# cluster of 8 to 16), 2,047 / 2,048 / 2,049, 3,840 / 3,841, 4,095 and
# 4,097 live keys, Tq 16 at rep 8 (16 passes of 8 rows), rep 7 at Tq 5 (35
# rows in 5 passes), a first position past the cache end (every key read):
# (KV heads, rep, hd, first positions, Tq, cache length)
GQA_CHECKED = ((2, 7, 64, [600, 1023], 1, 1024), (8, 5, 128, [1500], 5, 2048),
               (2, 7, 64, [300], 5, 1024),
               (2, 8, 128, [0], 1, 512), (2, 8, 128, [254], 1, 512), (2, 8, 64, [255], 1, 512),
               (2, 8, 128, [256], 1, 512), (2, 8, 128, [2046], 1, 4096),
               (2, 8, 64, [2047], 1, 4096), (2, 8, 128, [2048], 1, 4096),
               (2, 8, 128, [3839], 1, 4096), (2, 8, 128, [3840], 1, 4096),
               (8, 8, 128, [4094], 1, 4096), (8, 8, 128, [4096], 1, 8192),
               (2, 8, 128, [3000], 16, 4096), (2, 7, 128, [1999], 5, 2048),
               (2, 8, 128, [700, 599], 1, 600), (2, 8, 128, [63], 1, 512),
               (2, 8, 128, [64], 1, 512), (2, 8, 128, [959], 1, 1024),
               (2, 8, 128, [960], 1, 1024))
# K3 GQA's times before its Hopper redesign (the first form: fp32 SIMT
# products, 1-8 blocks a head) at each GQA_TIMED shape, int8 and int4: the
# readings of an earlier run of this script on an H100 80GB HBM3 at 700 W,
# not of this run
GQA_FIRST_FORM_MS = {8: (0.0271, 0.0153, 0.0472, 0.0392, 0.1198),
                     4: (0.0268, 0.0155, 0.0468, 0.0383, 0.1258)}


def _gqa_inputs(gen, n_kv, rep, hd, pos, tq, t, bits):
    """Random queries and a cache quantized as decode_step writes it."""
    dev = gen.device
    b = len(pos)
    k8, ks = quantize_kv(torch.randn((b, n_kv, t, hd), generator=gen, device=dev), bits)
    v8, vs = quantize_kv(torch.randn((b, n_kv, t, hd), generator=gen, device=dev), bits)
    q = torch.randn((b, n_kv * rep, tq, hd), generator=gen, device=dev)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    return q, (k8, ks, v8, vs), p, dict(scale=hd ** -0.5, live=min(t, max(pos) + tq))


def _gqa_fp_attention(q, p, live):
    """What models/qwen.py:decode_step runs over an fp cache (kv_bits 0), as
    a function of one layer's bf16 cache: its grouped attention to the
    longest row's live keys, the causal mask built once a step as there."""
    mask = gq.causal_mask(p, q.shape[2], live)

    def layer(kc, vc):
        return gq.grouped_attention(q, kc[:, :, :live], vc[:, :, :live], mask,
                                    q.shape[-1] ** -0.5).to(torch.bfloat16)

    return layer


def _gqa_timed(gen, q, cache, p, kw, yardsticks: bool, fp_einsum: bool = False) -> dict:
    """One shape of K3's GQA mode timed L2 cold over copies of the layer's
    cache, bf16 outputs; with ``yardsticks`` also bf16
    scaled_dot_product_attention(enable_gqa) at the same lengths and, with
    ``fp_einsum``, the fp cache's grouped einsum (what a kv_bits = 0 step
    runs), each over copies of a bf16 cache. -> ms by name."""
    copies = _layer_copies(lambda: tuple(x.clone() for x in cache), _nbytes(*cache))
    out = {"ms": _cold_ms(lambda c: gq.gqa_decode_attention(
        q, *c, p, out_dtype=torch.bfloat16, **kw), copies)}
    del copies
    if yardsticks:
        b, n_kv, t = cache[0].shape[:3]
        hd, tq, live = q.shape[-1], q.shape[2], kw["live"]
        kc = torch.randn((b, n_kv, t, hd), generator=gen, device=gen.device).to(torch.bfloat16)
        vc = torch.randn_like(kc)
        qb = q.to(torch.bfloat16)
        positions = p[:, None].long() + torch.arange(tq, device=p.device)
        mask = (torch.arange(live, device=p.device) <= positions[..., None])[:, None]
        copies = _layer_copies(lambda: (kc.clone(), vc.clone()), _nbytes(kc, vc))
        if fp_einsum:
            fp_layer = _gqa_fp_attention(q, p, live)
            out["fp_einsum_ms"] = _cold_ms(lambda c: fp_layer(*c), copies, reps=8)
        out["sdpa_ms"] = _cold_ms(lambda c: F.scaled_dot_product_attention(
            qb, c[0][:, :, :live], c[1][:, :, :live], attn_mask=mask, scale=hd ** -0.5,
            enable_gqa=True), copies)
        del copies, kc, vc
    return out


def _gqa_kernels(gen) -> dict:
    """K3's GQA mode against its plain version at GQA_TIMED and GQA_CHECKED,
    both code widths: each query row of a bf16 output within ATTN_TOL of its
    own max|ref|, of an fp32 output within GQA_FP32_TOL, bit-equal on a
    repeat, one device kernel a call; then timed L2 cold over copies of the
    layer's cache beside its plain version, the bound (the live codes and
    scales, q in and the bf16 output once), and two yardsticks at the same
    lengths: the fp cache's grouped einsum (what a kv_bits = 0 step runs)
    and scaled_dot_product_attention(enable_gqa) on a bf16 cache. No single
    PyTorch call attends over int codes with per-position scales: library
    none. -> K3's GQA fields for the JSON."""
    errs, times = [], {}
    cases = [(8, 8, 128, pos, tq, t, label) for label, pos, tq, t in GQA_TIMED]
    cases += [(n_kv, rep, hd, pos, tq, t, None) for n_kv, rep, hd, pos, tq, t in GQA_CHECKED]
    for bits in (8, 4):
        for n_kv, rep, hd, pos, tq, t, label in cases:
            q, cache, p, kw = _gqa_inputs(gen, n_kv, rep, hd, pos, tq, t, bits)

            def call(c=cache):
                return gq.gqa_decode_attention(q, *c, p, out_dtype=torch.bfloat16, **kw)

            name = (f"gqa int{bits} KV={n_kv} rep={rep} hd={hd} pos={pos} Tq={tq} T={t}")
            got = call()
            ref = gq.gqa_decode_attention_plain(q, *cache, p, **kw)
            errs.append(_check_rows(name, got, ref))
            if not torch.equal(got, call()):
                raise AssertionError(f"{name}: a repeat is not bit-equal")
            _check_rows(name + " fp32", gq.gqa_decode_attention(q, *cache, p, **kw), ref,
                        GQA_FP32_TOL)
            if label is None:
                continue
            if label == GQA_TIMED[0][0]:
                names, events = _device_kernels(call)
                host = _host_us(call)
                print(f"    device kernels: {names} by name, {events:g} events a call; host "
                      f"{host:.1f} us a call")
                if names != 1 or events > 1:
                    raise AssertionError(f"{name}: {names} device kernels by name, {events} "
                                         "events a call; one kernel a call expected")
            entry = _gqa_timed(gen, q, cache, p, kw, yardsticks=bits == 8, fp_einsum=True)
            ms = entry["ms"]
            entry["plain_ms"] = _device_ms(
                lambda: gq.gqa_decode_attention_plain(q, *cache, p, **kw), reps=3, warmup=1)
            nbytes, ops = _gqa_work(q, n_kv, rep, pos, tq, t, hd, bits)
            # the bound: the bytes or the operations at the tensor cores'
            # bf16 rate, where the products run (the bytes at every timed
            # shape); beside it the first form's reading, fp32 operations
            bound = _bound(nbytes, ops, "bf16")
            fp32 = _bound(nbytes, ops, "fp32")
            entry.update(**bound, fp32_ops_bound_ms=fp32["bound_ms"],
                         fp32_ops_bound_by=fp32["bound_by"])
            first = GQA_FIRST_FORM_MS[bits][[x[0] for x in GQA_TIMED].index(label)]
            times[(label, bits)] = entry
            print(f"    {label} int{bits}: kernel {ms:.4f} ms, plain {entry['plain_ms']:.4f} ms, "
                  f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}), "
                  f"{bound['bound_ms'] / ms:.1%} of it "
                  f"(with the operations at the fp32 rate {fp32['bound_ms']:.4f} ms, "
                  f"{fp32['bound_by']}); first form {first:.4f} ms in an earlier run, not "
                  "this one"
                  + (f"; fp cache grouped einsum {entry['fp_einsum_ms']:.4f} ms, "
                     f"scaled_dot_product_attention(enable_gqa) on bf16 "
                     f"{entry['sdpa_ms']:.4f} ms" if bits == 8 else ""))
            del cache, q
            torch.cuda.empty_cache()
    head = times[(GQA_TIMED[0][0], 8)]
    return dict(max_abs_err_gqa=max(errs), ms_gqa=head["ms"], plain_gqa_ms=head["plain_ms"],
                bound_gqa_ms=head["bound_ms"], bound_gqa_by=head["bound_by"],
                bound_gqa_fp32_ops_ms=head["fp32_ops_bound_ms"],
                bound_gqa_fp32_ops_by=head["fp32_ops_bound_by"],
                library_gqa_ms=None, yardstick_gqa_fp_einsum_ms=head["fp_einsum_ms"],
                yardstick_gqa_sdpa_ms=head["sdpa_ms"], host_gqa_us=host,
                ms_gqa_shapes={f"{label} int{bits}": e["ms"] for (label, bits), e in times.items()},
                bound_gqa_shapes={f"{label} int{bits}": e["bound_ms"]
                                  for (label, bits), e in times.items()})


def _gqa_work(q, n_kv, rep, pos, tq, t, hd, bits) -> tuple[int, int]:
    """K3 GQA's bytes (each row's live codes and scales, q in and the bf16
    output once) and its operations (QK and PV over each row's live keys)
    -> (bytes, operations)."""
    live_rows = [min(t, x + tq) for x in pos]
    per_key = 2 * (hd * bits // 8 + 2)  # K and V codes and their bf16 scales
    return (sum(n_kv * x * per_key for x in live_rows) + _nbytes(q) + q.numel() * 2,
            sum(2 * 2 * n_kv * rep * tq * hd * x for x in live_rows))


def _tiled_keys(tiled: dict) -> dict:
    """The K5 and K6 rows' tiled-core fields: one layer's four linears at
    384 rows, L2 cold, and their bound."""
    ms, lib, bound = tiled[384]
    return dict(ms_tiled=ms, bound_tiled=bound["bound_ms"], bound_tiled_by=bound["bound_by"],
                yardstick_tiled_ms=lib)


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
    save_safetensors_file(os.path.join(path, "model.safetensors"), state)


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
    new = 32  # tokens a request, short for the whole run's time limit

    qm.LAUNCHES = qm.TILED_LAUNCHES = fa.LAUNCHES = 0
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
    launches = {"quant": qm.LAUNCHES, "flash": fa.LAUNCHES, "quant_tiled": qm.TILED_LAUNCHES}
    print(f"  launches on the LLM main path: quant_matmul {launches['quant']} (the tiled "
          f"core {launches['quant_tiled']}: the prefills), flash_attention {launches['flash']}")
    for key, n in launches.items():
        assert n > 0, f"kernel {key} was not launched on the LLM main path"
    batch.close()
    _llm_rates(params, config)
    print(f"  llm peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def _sync_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _prefill_ms(params, config, t: int) -> float:
    """One prefill of t random tokens into a fresh cache (host clock around
    a synchronized decode_step), its logits checked for shape and finite
    values. -> ms."""
    dev = torch.device("cuda")
    toks = torch.randint(0, 256, (1, t), device=dev)
    cache = qw.init_kv_cache(config, 1, 4096, dev)
    logits, ms = _sync_ms(lambda: qw.decode_step(params, toks, 0, cache, config)[0])
    assert logits.shape == (1, t, config.vocab_size), logits.shape
    assert torch.isfinite(logits).all(), "non-finite Qwen3-32B prefill logits"
    return ms


def _llm_rates(params, config) -> None:
    """Prefill tok/s at 128, 384 and 512 tokens (the tiled core's prompts,
    one launch a linear) and 1536 (dequantize + matmul); decode tok/s at B
    = 1 and 4 (host clock around synchronized steps); device busy time of
    decode steps under torch.profiler."""
    dev = torch.device("cuda")
    for t in (128, 384, 512, 1536):
        ms = _prefill_ms(params, config, t)
        print(f"  prefill T={t}: {ms:.2f} ms, {t / ms * 1e3:.1f} tok/s")
    for rows in (1, 4):
        cache = qw.init_kv_cache(config, rows, 4096, dev)
        tok1 = torch.zeros((rows, 1), dtype=torch.long, device=dev)
        pos = 400 if rows == 1 else [400 + 37 * i for i in range(rows)]

        def steps(n):
            for i in range(n):
                p = pos + i if rows == 1 else [x + i for x in pos]
                qw.decode_step(params, tok1, p, cache, config)

        steps(2)
        # 8 timed steps and 4 profiled (cut from 16 and 8 for the whole run's
        # time limit)
        _, ms = _sync_ms(lambda: steps(8))
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            _, prof_ms = _sync_ms(lambda: steps(4))
        device_us, top = _kernel_us(prof)
        print(f"  decode B={rows}: {ms / 8:.3f} ms/step, {rows * 8 / ms * 1e3:.2f} tok/s; "
              f"under the profiler wall {prof_ms / 4:.3f} ms/step, device kernels "
              + (f"{device_us / 1e3 / 4:.3f} ms/step, device idle share "
                 f"{1 - device_us / 1e3 / prof_ms:.3f}" if device_us else "not measured"))
        for e in top[:6]:
            print(f"    {e.key[:60]:60s} device {e.self_device_time_total / 4:9.1f} "
                  f"us/step, calls {e.count // 4}/step")
        del cache


# ---------------------------------------------------------------------------
# the LLM's weight residency: K6 (WTPU_MBT_RESIDENT), K7 (WTPU_QWEN_A8)
# ---------------------------------------------------------------------------


def _layer_copies(make, nbytes: int) -> list:
    """Copies of one linear whose bytes together pass 100 MB, twice the L2,
    so that cycling through them finds each cold as a decode step does."""
    return [make() for _ in range(max(1, -(-100_000_000 // nbytes)))]


def _mbt_copy(qt):
    return dataclasses.replace(qt, wqt=qt.wqt.clone(), scalest=qt.scalest.clone(),
                               biasest=qt.biasest.clone())


def _a8_copy(at):
    return dataclasses.replace(at, codes=at.codes.clone(), scale=at.scale.clone())


def _random_quant(gen, n, k, bits=4):
    """Random normal weights quantized 16384 rows at a time (phase 7's)."""
    return tq.stack_quant([
        tq.quantize(torch.randn((min(16384, n - r), k), generator=gen, device=gen.device)
                    * k ** -0.5, bits) for r in range(0, n, 16384)])


def _mbt_beside_k5(q, copies, gen, sums: dict) -> None:
    """K6 on packed int4 at M = 1 with the ring 2, 4 and 8 deep and at M = 4
    at the layout's depth, and K5 on the same weights as they are packed at
    M = 1 and 4, all with L2 cold: what the ring's depth and the transposed
    layout buy. Adds each time to ``sums``."""
    n, k = q.shape
    xs = {m: torch.randn((m, k), generator=gen, device=gen.device).to(torch.bfloat16)
          for m in (1, 4)}
    for depth in (2, 4, 8):
        sums[f"K6 depth {depth}"] += _cold_ms(
            lambda c: tq.quant_matmul(xs[1], c), [dataclasses.replace(c, depth=depth) for c in copies])
    sums["K6 M=4"] += _cold_ms(lambda c: tq.quant_matmul(xs[4], c), copies)
    nbytes = _nbytes(q.w_q, q.scales, q.biases)
    packed = _layer_copies(lambda: dataclasses.replace(
        q, w_q=q.w_q.clone(), scales=q.scales.clone(), biases=q.biases.clone()), nbytes)
    for m in (1, 4):
        sums["K5" if m == 1 else "K5 M=4"] += _cold_ms(lambda c: tq.quant_matmul(xs[m], c), packed)
    print("    L2 cold: " + ", ".join(f"{key} {ms:.4f} ms" for key, ms in sums.items())
          + " (M = 1 unless named; summed over the linears so far)")


def _spin_pad(launches: int) -> None:
    """``launches`` short device spins (``spin_kernel``, left out of every
    count)."""
    for _ in range(launches):
        torch.cuda._sleep(100)


def _device_kernels(fn, calls: int = 64) -> tuple[int, float]:
    """The device kernels (and copies) of ``fn``'s calls, from the
    profiler's device events over ``calls`` calls after one that warms
    them: (distinct names, events a call). The profiler drops events at a
    window's edges on the H100, more as a run goes on: about 30 of a
    window's first kernels late in a whole run, all 32 of 16 two-kernel
    calls once. So the window opens on a long spin of the device and 256
    short ones, and closes on 64 short ones, all left out of the count. A
    window that saw no kernel of ``fn`` measured nothing and is taken
    again, at most twice; the events a call may still undercount, a name
    seen in the window ran."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=activities) as prof:
            torch.cuda._sleep(int(1e7))
            _spin_pad(256)
            for _ in range(calls):
                fn()
            _spin_pad(64)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and "spin" not in e.key]
        if events:
            break
    return len(events), sum(e.count for e in events) / calls


def _time_residency(label, leaf, call, plain, copies, nbytes, kind, gen, errs, exact=False,
                    one_kernel=False):
    """One leaf against its plain version at M = 1, 4, 128 and 384 (``exact``:
    bit-equal; ``one_kernel``: one device kernel a call at M <= 8); returns
    the M = 1 (kernel ms, plain ms, host us a call) with L2 cold."""
    n, k = leaf.shape
    out = None
    for m in (1, 4, 128, 384):
        x = torch.randn((m, k), generator=gen, device=gen.device).to(torch.bfloat16)
        got, ref = call(x, leaf), plain(x, leaf)
        tol = 0.0 if exact else QMM_TOL * max(1.0, ref.float().abs().max().item())
        errs.append(_check(f"{label} N={n} K={k} M={m}", got, ref, tol))
        del got, ref
        if one_kernel and m <= 8:
            names, events = _device_kernels(lambda: call(x, leaf))
            print(f"    device kernels: {names} by name, {events:g} events a call")
            if names != 1 or events > 1:
                raise AssertionError(f"{label} M={m}: {names} device kernels by name, "
                                     f"{events} events a call; one kernel a call expected")
        ms = _cold_ms(lambda c: call(x, c), copies, reps=24 if m <= 4 else 8)
        bound = _bound(nbytes + 2 * m * (n + k), 2 * m * n * k, kind)
        print(f"    kernel {ms:.4f} ms, {nbytes / ms / 1e6:.1f} GB/s of weights; bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
        if m == 1:
            out = (ms, _device_ms(lambda: plain(x, leaf), reps=3, warmup=1),
                   _host_us(lambda: call(x, leaf)))
            print(f"    plain {out[1]:.4f} ms; host {out[2]:.1f} us a call")
    return out


def phase_residency_kernels() -> dict:
    """K6 and K7 against their plain versions at the Qwen3-32B linear shapes
    (M = 1, 4, 128, 384): K6 on packed int4 (the layer's four linears; the
    head stays packed under WTPU_MBT_RESIDENT), codes-resident int4 and the
    int8 qkv; K7 on the four linears and the head, each with its VMEM-rule
    verdict at decode and prefill (the kernel is timed either way); K6's
    tiled core at every edge of its row blocks on those leaves and
    whisper's ragged logits, and timed over one layer (packed at 128, 384
    and 512 rows, codes-resident at 384). Returns the JSON rows: M = 1, L2
    cold, bound from the run's bytes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    # ms, plain, bytes, ops, host us
    sums = {key: [0.0, 0.0, 0, 0, 0.0] for key in ("mbt", "mbt_i8", "a8")}
    errs = {"mbt": [], "a8": []}
    lib_ms, lib_bytes = 0.0, 0
    beside = {key: 0.0 for key in ("K6 depth 2", "K6 depth 4", "K6 depth 8", "K6 M=4", "K5",
                                   "K5 M=4")}
    for name, n, k in QWEN_LINEARS:
        q = _random_quant(gen, n, k)
        x1 = 2 * (n + k)  # bf16 x in and y out at M = 1
        if name != "lm_head":
            for codes, key in ((False, "mbt"), (True, "mbt_i8")):
                qt = mb.transpose_quant(q, codes=codes)
                nbytes = _nbytes(qt.wqt, qt.scalest, qt.biasest)
                copies = _layer_copies(lambda: _mbt_copy(qt), nbytes)
                print(f"  {qt!r}")
                ms, plain, host = _time_residency(
                    f"quant_matmul_mbt {name}{' i8' if codes else ''}", qt, tq.quant_matmul,
                    mb.quant_matmul_mbt_plain, copies, nbytes, "bf16", gen, errs["mbt"],
                    one_kernel=True)
                for i, v in enumerate((ms, plain, nbytes + x1, 2 * n * k, host)):
                    sums[key][i] += v
                if not codes:
                    _mbt_beside_k5(q, copies, gen, beside)
                if qt.codes_resident == codes:  # codes-resident only up to 8192 k
                    errs["mbt"].append(_check_tiled(f"quant_matmul_mbt {qt!r}", qt,
                                                    mb.quant_matmul_mbt_plain, mb, gen))
                del qt, copies
        at = a8.requant_a8(q)
        del q
        route = {m: "kernel" if a8.a8_fits(at, m) else "dequantize + matmul" for m in (1, 384)}
        print(f"  {at!r}: the VMEM rule sends M = 1 to the {route[1]}, M = 384 to the "
              f"{route[384]}; the kernel is timed at every M")
        nbytes = _nbytes(at.codes, at.scale)
        copies = _layer_copies(lambda: _a8_copy(at), nbytes)
        ms, plain, host = _time_residency(f"a8_matmul {name}", at, a8.a8_matmul_kernel,
                                          a8.a8_matmul_plain, copies, nbytes, "int8", gen,
                                          errs["a8"], exact=True, one_kernel=True)
        if name in ("qkv", "o"):
            _check_a8_tiled(f"a8_matmul {name}", at, gen)
        for i, v in enumerate((ms, plain, nbytes + x1, 2 * n * k, host)):
            sums["a8"][i] += v
        # the library's int8 GEMM: the int32 product alone, at the fewest
        # rows torch._int_mm takes (17), without the activation
        # quantization or the scales
        xq = torch.randint(-127, 128, (17, k), generator=gen, device=dev, dtype=torch.int8)
        lib_ms += _cold_ms(lambda c: torch._int_mm(xq, c.codes.t()), copies)
        lib_bytes += nbytes
        del at, copies
        torch.cuda.empty_cache()
    q = _random_quant(gen, 10240, 5120, bits=8)
    qt = mb.transpose_quant(q)
    del q
    nbytes = _nbytes(qt.wqt, qt.scalest, qt.biasest)
    _time_residency("quant_matmul_mbt qkv int8", qt, tq.quant_matmul,
                    mb.quant_matmul_mbt_plain, _layer_copies(lambda: _mbt_copy(qt), nbytes),
                    nbytes, "bf16", gen, errs["mbt"])
    errs["mbt"].append(_check_tiled(f"quant_matmul_mbt {qt!r}", qt, mb.quant_matmul_mbt_plain,
                                    mb, gen))
    _, n, k = WHISPER_LOGITS
    qt = mb.transpose_quant(_random_quant(gen, n, k))
    errs["mbt"].append(_check_tiled(f"quant_matmul_mbt whisper logits {qt!r}", qt,
                                    mb.quant_matmul_mbt_plain, mb, gen))
    del qt
    torch.cuda.empty_cache()
    tiled = _tiled_layer(gen, lambda q: mb.transpose_quant(q, codes=False), label="K6 packed")
    _tiled_layer(gen, lambda q: mb.transpose_quant(q, codes=True), m_values=(384,),
                 label="K6 codes-resident (down packed: K past 8192)")
    a8_tiled = _a8_tiled_layer(gen)
    for key, (ms, plain, nbytes, ops, host) in sums.items():
        what = "the four linears and the head" if key == "a8" else "the four linears"
        print(f"  {key} at M = 1 over {what}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"{nbytes / 1e6:.1f} MB, bound "
              f"{_bound(nbytes, ops, 'int8' if key == 'a8' else 'bf16')['bound_ms']:.4f} ms, "
              f"host {host:.1f} us over the calls")
    print(f"  torch._int_mm at M = 17 (the fewest rows it takes; the int32 product only) over "
          f"the same five: {lib_ms:.4f} ms ({lib_bytes / lib_ms / 1e6:.1f} GB/s of codes)")
    ms, plain, nbytes, ops, _ = sums["mbt"]
    rows = {"mbt": dict(
        name="quant_matmul_mbt", route="cuda",
        source="whisper_mlx_tpu_torch/csrc/quant_matmul_mb.cu",
        replaces="whisper_mlx_tpu/ops/quant_pallas_mb.py:354", max_abs_err=max(errs["mbt"]),
        ms=ms, plain_ms=plain, **_bound(nbytes, ops, "bf16"),
        library_ms=_INT4PACK.get("m1_four"), library_tiled_ms=_INT4PACK.get("m384"),
        **_tiled_keys(tiled))}
    ms, plain, nbytes, ops, _ = sums["a8"]
    rows["a8"] = dict(
        name="a8_matmul", route="cuda", source="whisper_mlx_tpu_torch/csrc/a8_matmul.cu",
        replaces="whisper_mlx_tpu/ops/quant_a8.py:198", max_abs_err=max(errs["a8"]),
        ms=ms, plain_ms=plain, **_bound(nbytes, ops, "int8"), library_ms=lib_ms,
        ms_tiled=a8_tiled[384]["ms"], bound_tiled=a8_tiled[384]["bound_ms"],
        bound_tiled_by=a8_tiled[384]["bound_by"], library_tiled_ms=a8_tiled[384]["int_mm_ms"],
        quantize_tiled_ms=a8_tiled[384]["quantize_ms"])
    return rows


# the row counts at which K7's tiled route (more than 8 rows) is held
# bit-equal to its plain version: each edge of its 16-, 32-, 64- and 128-row
# blocks, and past 512 rows (the VMEM rule admits qkv to about 810 rows)
A8_TILED_M = (9, 16, 17, 63, 64, 65, 127, 128, 129, 384, 511, 512, 1000)
# the prefill lengths at which it is timed
A8_TILED_TIMED = (128, 384, 512)


def _check_a8_tiled(label, at, gen, m_values=A8_TILED_M) -> None:
    """K7's tiled route on one linear at each of ``m_values`` rows: bit-equal
    to its plain version and on a repeat, one tiled launch, two device
    kernels a call (x's quantization, the GEMM)."""
    n, k = at.shape
    seen = []
    for m in m_values:
        x = torch.randn((m, k), generator=gen, device=gen.device).to(torch.bfloat16)
        before = a8.TILED_LAUNCHES
        got = a8.a8_matmul_kernel(x, at)
        if a8.TILED_LAUNCHES != before + 1:
            raise AssertionError(f"{label} M={m}: not one launch of the tiled route")
        if not torch.equal(got, a8.a8_matmul_plain(x, at)):
            raise AssertionError(f"{label} N={n} K={k} M={m}: not bit-equal to the plain version")
        if not torch.equal(got, a8.a8_matmul_kernel(x, at)):
            raise AssertionError(f"{label} N={n} K={k} M={m}: a repeat is not bit-equal")
        del got
        names, events = _device_kernels(lambda: a8.a8_matmul_kernel(x, at))
        if names != 2 or events > 2:
            raise AssertionError(f"{label} M={m}: {names} device kernels by name, {events} "
                                 "events a call; two expected (quantize, GEMM)")
        seen.append(events)
    print(f"  {label} N={n} K={k}, tiled route at M = {', '.join(map(str, m_values))}: bit-equal "
          "to the plain version and on a repeat, two device kernels a call (events a call "
          f"{min(seen):g}-{max(seen):g})")


def _a8_tiled_layer(gen, m_values=A8_TILED_TIMED) -> dict:
    """K7's tiled route over one Qwen3-32B layer's four linears (qkv, o,
    gate_up, down; the VMEM rule's verdict aside) at each of ``m_values``
    rows, L2 cold: the whole call, x's quantization launch alone (x warm, as
    the layer before leaves it), and torch._int_mm's int32 product of the
    same rows (a yardstick: no activation quantization, no scales), beside
    the bound. Only public calls and the quantization's C entry, so that an
    earlier tree runs it too. -> {m: dict(ms, quantize_ms, int_mm_ms,
    bound_ms, bound_by)}."""
    dev = gen.device
    lib = _build.lib()
    sums = {m: [0.0, 0.0, 0.0, 0, 0] for m in m_values}  # call, quantize, int_mm, bytes, ops
    for name, n, k in QWEN_LINEARS[:4]:
        q = _random_quant(gen, n, k)
        at = a8.requant_a8(q)
        del q
        nbytes = _nbytes(at.codes, at.scale)
        copies = _layer_copies(lambda: _a8_copy(at), nbytes)
        for m in m_values:
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            xq = torch.empty((m, k), dtype=torch.int8, device=dev)
            sx = torch.empty((m,), dtype=torch.float32, device=dev)
            xi = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)

            def quantize():
                _build.check(lib.wmt_a8_quantize(x.data_ptr(), xq.data_ptr(), sx.data_ptr(), m, k,
                                                 1, torch.cuda.current_stream().cuda_stream),
                             "wmt_a8_quantize")

            for i, v in enumerate((_cold_ms(lambda c: a8.a8_matmul_kernel(x, c), copies, reps=8),
                                   _device_ms(quantize),
                                   _cold_ms(lambda c: torch._int_mm(xi, c.codes.t()), copies,
                                            reps=8),
                                   nbytes + 2 * m * (n + k), 2 * m * n * k)):
                sums[m][i] += v
        del at, copies
        torch.cuda.empty_cache()
    res = {}
    for m, (ms, qms, ims, nbytes, ops) in sums.items():
        bound = _bound(nbytes, ops, "int8")
        res[m] = dict(ms=ms, quantize_ms=qms, int_mm_ms=ims, **bound)
        print(f"  K7 tiled route, one Qwen3-32B layer's four linears at M={m}, L2 cold: {ms:.4f} ms "
              f"({ops / ms / 1e9:.1f} TOP/s, {bound['bound_ms'] / ms:.1%} of the bound "
              f"{bound['bound_ms']:.4f} ms by {bound['bound_by']}); torch._int_mm, the int32 "
              f"product alone: {ims:.4f} ms ({ms / ims:.2f}x)")
        print(f"  K7 tiled route's x quantization launch alone at M={m}, over the four: "
              f"{qms:.4f} ms")
    return res


# whisper large-v3's decoder linears under WTPU_FEWROW_MBT=1, (N, K, calls a
# decode step): fused self qkv, self o, cross q, cross o, fc1, fc2
LARGE_V3_STEP = ((3840, 1280, 32), (1280, 1280, 32), (1280, 1280, 32), (1280, 1280, 32),
                 (5120, 1280, 32), (1280, 5120, 32))


def phase_residency_times() -> None:
    """Phase 17, run only when named: K6 (four Qwen3-32B linears, packed
    int4, the layout's default depth) and K7 (the five) at M = 1 and 4,
    L2 cold, beside K5 on the same packed weights and torch._int_mm at 17
    rows; each call's device kernels and host cost at M = 1; K6 and K5
    over a large-v3 decode step's leaves at 8 rows. No check of one tree's
    design, so that two trees run it in turn in one call."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    ms = {key: 0.0 for key in ("K6 M=1", "K6 M=4", "K5 M=1", "K5 M=4", "K7 M=1", "K7 M=4",
                               "int_mm M=17", "K6 host us", "K7 host us")}
    kernels = {"K6": [], "K7": []}
    for name, n, k in QWEN_LINEARS:
        q = _random_quant(gen, n, k)
        xs = {m: torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16) for m in (1, 4)}
        if name != "lm_head":
            qt = mb.transpose_quant(q)
            leaves = {"K6": _layer_copies(lambda: _mbt_copy(qt), _nbytes(qt.wqt, qt.scalest,
                                                                        qt.biasest)),
                      "K5": _layer_copies(lambda: dataclasses.replace(
                          q, w_q=q.w_q.clone(), scales=q.scales.clone(),
                          biases=q.biases.clone()), _nbytes(q.w_q, q.scales, q.biases))}
            for key, copies in leaves.items():
                for m in (1, 4):
                    ms[f"{key} M={m}"] += _cold_ms(lambda c: tq.quant_matmul(xs[m], c), copies)
            ms["K6 host us"] += _host_us(lambda: tq.quant_matmul(xs[1], qt))
            kernels["K6"].append(_device_kernels(lambda: tq.quant_matmul(xs[1], qt)))
            del qt, leaves
        at = a8.requant_a8(q)
        del q
        copies = _layer_copies(lambda: _a8_copy(at), _nbytes(at.codes, at.scale))
        for m in (1, 4):
            ms[f"K7 M={m}"] += _cold_ms(lambda c: a8.a8_matmul_kernel(xs[m], c), copies)
        xq = torch.randint(-127, 128, (17, k), generator=gen, device=dev, dtype=torch.int8)
        ms["int_mm M=17"] += _cold_ms(lambda c: torch._int_mm(xq, c.codes.t()), copies)
        ms["K7 host us"] += _host_us(lambda: a8.a8_matmul_kernel(xs[1], at))
        kernels["K7"].append(_device_kernels(lambda: a8.a8_matmul_kernel(xs[1], at)))
        del at, copies
        torch.cuda.empty_cache()
    print("  Qwen3-32B, L2 cold, summed over K6's four linears and K7's five: "
          + ", ".join(f"{key} {v:.4f}" + (" us" if "host" in key else " ms")
                      for key, v in ms.items()))
    print(f"  device kernels at M = 1, by linear (distinct names, events a call): {kernels}")
    step = {"K6": 0.0, "K5": 0.0}
    for n, k, calls in LARGE_V3_STEP:
        q = _random_quant(gen, n, k)
        qt = mb.transpose_quant(q)
        x = torch.randn((8, k), generator=gen, device=dev).to(torch.bfloat16)
        step["K6"] += calls * _cold_ms(lambda c: tq.quant_matmul(x, c), _layer_copies(
            lambda: _mbt_copy(qt), _nbytes(qt.wqt, qt.scalest, qt.biasest)))
        step["K5"] += calls * _cold_ms(lambda c: tq.quant_matmul(x, c), _layer_copies(
            lambda: dataclasses.replace(q, w_q=q.w_q.clone(), scales=q.scales.clone(),
                                        biases=q.biases.clone()), _nbytes(q.w_q, q.scales,
                                                                          q.biases)))
    print(f"  large-v3 decode step's leaves at 8 rows (192 calls, the logits left out), L2 "
          f"cold: K6 {step['K6']:.4f} ms, K5 {step['K5']:.4f} ms")


RESIDENCY = {  # env var -> (its kernel's module, the JSON row's key, extra env)
    "WTPU_MBT_RESIDENT": (mb, "mbt", {}),
    "WTPU_QWEN_A8": (a8, "a8", {"WTPU_A8_FREE_SRC": "1"}),
}


RESIDENCY_LAYERS = 16  # of Qwen3-32B's 64: the depth is cut, every width is full


def phase_llm_residency(env: str) -> dict:
    """One residency opt-in: the tiny Qwen card-vs-CPU check (phase 8) under
    it, then Qwen3-32B at full width and RESIDENCY_LAYERS layers (random
    packed int4 weights built on the card, converted by LLMEngine) through
    chat and the 4-slot continuous-batching engine, each request checked for
    its token count, then the prefill and decode rates with a profiled
    decode window. Returns the opt-in's kernel launches over the chat and
    batch run."""
    module, key, extra = RESIDENCY[env]
    settings = {env: "1", **extra}
    os.environ.update(settings)
    try:
        _timed_phase(f"tiny qwen {env}=1", phase_tiny_qwen)
        dev = torch.device("cuda")
        torch.cuda.reset_peak_memory_stats()
        config = dataclasses.replace(QWEN32, dtype=torch.bfloat16, flash_attention=True,
                                     num_hidden_layers=RESIDENCY_LAYERS)
        params = qw.init_random_quant_params(config, seed=0, device=dev)
        t0 = time.perf_counter()
        tok = _CountingTokenizer()
        engine = LLMEngine(params, config, tok, max_context=4096)
        del params
        torch.cuda.synchronize()
        leaves = {name: type(engine.params["layers"][0][part][name]["w"]).__name__
                  for part, name in (("attn", "qkv"), ("attn", "o"), ("mlp", "gate_up"),
                                     ("mlp", "down"))}
        leaves["lm_head"] = type(engine.params["lm_head"]["w"]).__name__
        print(f"llm {env}=1 ({RESIDENCY_LAYERS} layers): converted in "
              f"{time.perf_counter() - t0:.2f} s, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident, "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; leaves {leaves}")
        rng = np.random.default_rng(7)
        new = 32
        mb.LAUNCHES = a8.LAUNCHES = qm.LAUNCHES = fa.LAUNCHES = 0
        mb.TILED_LAUNCHES = qm.TILED_LAUNCHES = a8.TILED_LAUNCHES = 0
        a8.VMEM_DEQUANT_CALLS = a8.ROWS_DEQUANT_CALLS = 0
        t0 = time.perf_counter()
        r = engine.chat([{"role": "user", "content": _prompt_text(rng, 270)}], max_tokens=new,
                        temperature=0.0)
        print(f"  chat: prompt {r.prompt_tokens} tokens, {r.generation_tokens} new in "
              f"{time.perf_counter() - t0:.3f} s")
        assert r.generation_tokens == new, f"chat returned {r.generation_tokens} of {new} tokens"
        batch = engine.continuous(4)
        t0 = time.perf_counter()
        handles = [batch.submit(_prompt_text(rng, 100 + 40 * i), max_tokens=new,
                                temperature=0.0) for i in range(6)]
        counts = [len(list(h.tokens())) for h in handles]
        batch_s = time.perf_counter() - t0
        assert batch.alive, "the batch engine's worker thread died"
        assert counts == [new] * 6, f"batch requests received {counts} tokens"
        torch.cuda.synchronize()
        launches = {key: module.LAUNCHES}
        if module is mb:  # the prefills on K6's tiled core
            launches["mbt_tiled"] = mb.TILED_LAUNCHES
            assert mb.TILED_LAUNCHES > 0, "K6's tiled core was not launched under MBT"
        if module is a8:  # the prefills' qkv and o on K7's tiled route
            launches["a8_tiled"] = a8.TILED_LAUNCHES
            print(f"  A8 calls by route over the chat and the batch: K7 GEMV "
                  f"{a8.LAUNCHES - a8.TILED_LAUNCHES}, K7 tiled {a8.TILED_LAUNCHES}, dequantize + "
                  f"matmul by the VMEM rule {a8.VMEM_DEQUANT_CALLS}, past 512 rows "
                  f"{a8.ROWS_DEQUANT_CALLS}")
            assert a8.TILED_LAUNCHES > 0, "K7's tiled route was not launched under A8"
        print(f"  continuous batching: 6 requests x {new} tokens on 4 slots in {batch_s:.3f} s "
              f"({6 * new / batch_s:.2f} tok/s); launches {key} {module.LAUNCHES} (tiled core "
              f"{getattr(module, 'TILED_LAUNCHES', 0)}), quant_matmul {qm.LAUNCHES}, "
              f"flash_attention {fa.LAUNCHES}")
        assert module.LAUNCHES > 0, f"kernel {key} was not launched under {env}=1"
        batch.close()
        _llm_rates(engine.params, config)
        if module is a8:
            _a8_prefill_split(engine.params, config)
        print(f"  llm {env}=1 peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        return launches
    finally:
        for name in settings:
            os.environ.pop(name, None)


def _a8_prefill_split(params, config, t: int = 384) -> None:
    """One profiled t-token prefill under WTPU_QWEN_A8=1: the device ms of
    the calls on K7 (its kernels by name: the tiled GEMM, x's quantization,
    the GEMV) against the calls the VMEM rule sends to dequantize + matmul
    (a record_function range around each such call), and the calls by
    route."""
    orig = a8.a8_matmul

    def traced(x, at):
        kernel = a8.a8_fits(at, x.numel() // x.shape[-1])
        with torch.profiler.record_function("a8_kernel_route" if kernel else "a8_dequant_route"):
            return orig(x, at)

    before = (a8.LAUNCHES, a8.TILED_LAUNCHES, a8.VMEM_DEQUANT_CALLS, a8.ROWS_DEQUANT_CALLS)
    _prefill_ms(params, config, t)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    a8.a8_matmul = traced
    try:
        with torch.profiler.profile(activities=activities) as prof:
            torch.cuda._sleep(int(1e7))
            ms = _prefill_ms(params, config, t)
    finally:
        a8.a8_matmul = orig
    _, events = _kernel_us(prof)
    # the ranges also appear among the device's events: left out of the sum
    ranges = ("a8_kernel_route", "a8_dequant_route")
    total = sum(e.self_device_time_total for e in events
                if e.key not in ranges and "spin" not in e.key)
    by_name = {"tiled GEMM": "a8_gemm_kernel", "quantize": "a8_quantize_kernel",
               "GEMV": "a8_gemv_kernel"}
    k7 = {label: sum(e.self_device_time_total for e in events if key in e.key) / 1e3
          for label, key in by_name.items()}
    under = {}
    for e in prof.key_averages():
        if e.key in ranges:
            under[e.key] = max(under.get(e.key, 0.0), e.device_time_total / 1e3)
    after = (a8.LAUNCHES, a8.TILED_LAUNCHES, a8.VMEM_DEQUANT_CALLS, a8.ROWS_DEQUANT_CALLS)
    calls = [b - a for a, b in zip(before, after)]
    print(f"  A8 prefill T={t} under the profiler: wall {ms:.2f} ms, device {total / 1e3:.3f} ms; "
          f"K7 kernels {', '.join(f'{k} {v:.3f} ms' for k, v in k7.items())}; device ms under "
          f"the calls on K7 {under.get('a8_kernel_route', 0.0):.3f}, under the VMEM rule's "
          f"dequantize + matmul {under.get('a8_dequant_route', 0.0):.3f}")
    print(f"  A8 prefill T={t}: calls by route (two prefills, the warm-up's included): K7 GEMV "
          f"{calls[0] - calls[1]}, K7 tiled {calls[1]}, VMEM rule dequantize + matmul "
          f"{calls[2]}, past 512 rows {calls[3]}")


def phase_a8_times() -> None:
    """Phase 21, run only when named: K7's tiled route, its quantization
    launch and torch._int_mm over one Qwen3-32B layer's four linears at 128,
    384 and 512 rows, K1 at 3000 and 9,500 frames, and the A8 prefill (16
    layers under WTPU_QWEN_A8=1) at 128, 384, 512 and 1536 tokens. Public
    calls only and no check of one tree's design, so that two trees run it
    in turn in one call."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(41)
    _a8_tiled_layer(gen)
    rng = np.random.default_rng(0)
    cases = {}
    for label, seconds in (("3000", 30), ("9500", 95)):
        audio = torch.from_numpy(rng.standard_normal(seconds * 16000).astype(np.float32)
                                 * 0.1).to(dev)
        cases[label] = _frame_signal(audio, 400, 160)[:-1].contiguous()
    _mel_times(cases)
    os.environ.update({"WTPU_QWEN_A8": "1", "WTPU_A8_FREE_SRC": "1"})
    try:
        config = dataclasses.replace(QWEN32, dtype=torch.bfloat16, flash_attention=True,
                                     num_hidden_layers=RESIDENCY_LAYERS)
        engine = LLMEngine(qw.init_random_quant_params(config, seed=0, device=dev), config,
                           _CountingTokenizer(), max_context=4096)
        _prefill_rates(engine.params, config, f"WTPU_QWEN_A8=1, {RESIDENCY_LAYERS} layers",
                       lengths=(128, 384, 512, 1536))
        del engine
    finally:
        for name in ("WTPU_QWEN_A8", "WTPU_A8_FREE_SRC"):
            os.environ.pop(name, None)


def phase_gqa_times() -> None:
    """Phase 28, run only when named: K3's GQA mode at each GQA_TIMED shape,
    int8 and int4, L2 cold, beside its bound (bytes) and bf16
    scaled_dot_product_attention(enable_gqa) at the same lengths. Where the
    tree has them: the kernel's ptxas lines and the room for its clusters of
    16 and 8 blocks. Public calls only otherwise and no check of one tree's
    design, so that two trees run it in turn in one call."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    lines = str(_build.BUILD_LOG.get("stderr", "")).splitlines()
    for i, line in enumerate(lines):
        if "gqa_attn_kernel" in line and "Compiling entry" in line:
            print("  ptxas: " + line.split("'")[1][:64] + ": " + " / ".join(
                x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]))
    if hasattr(gq, "gqa_cluster_room"):
        for hd, bits in ((128, 8), (128, 4), (64, 8), (64, 4)):
            print(f"  clusters held at once, hd {hd} int{bits}: "
                  + ", ".join(f"{c} blocks {gq.gqa_cluster_room(dev, hd, bits, c)}"
                              for c in (16, 8)))
    for bits in (8, 4):
        for label, pos, tq, t in GQA_TIMED:
            q, cache, p, kw = _gqa_inputs(gen, 8, 8, 128, pos, tq, t, bits)
            got = _gqa_timed(gen, q, cache, p, kw, yardsticks=bits == 8)
            bound = _bound(*_gqa_work(q, 8, 8, pos, tq, t, 128, bits), "bf16")
            print(f"  gqa_times {label} int{bits}: kernel {got['ms']:.4f} ms, bound "
                  f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}), "
                  f"{bound['bound_ms'] / got['ms']:.1%} of it"
                  + (f"; scaled_dot_product_attention(enable_gqa) on bf16 "
                     f"{got['sdpa_ms']:.4f} ms" if bits == 8 else ""))
            del cache, q
            torch.cuda.empty_cache()


# the copies of K3's GQA kernel that phase 29 builds: each keeps only the hi
# fp16 part of one split operand
GQA_ONE_PART = {"query hi only": ("constexpr int QP = 2;", "constexpr int QP = 1;"),
                "weights hi only": ("constexpr int WP = 2;", "constexpr int WP = 1;")}


def _gqa_one_part_libs() -> dict:
    """Build each copy of GQA_ONE_PART from csrc/gqa_decode_attention.cu
    altered under build/gqa_split/ (never in csrc/), one nvcc each, all at
    once -> name -> its library, bound like _build's."""
    src = _build.CSRC / "gqa_decode_attention.cu"
    text = src.read_text()
    root = _build.BUILD_DIR.parent / "gqa_split"
    builds = {}
    for name, (old, new) in GQA_ONE_PART.items():
        if text.count(old) != 1:
            raise AssertionError(f"{src.name}: '{old}' not found once")
        d = root / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        for header in _build.CSRC.glob("*.cuh"):
            shutil.copy(header, d)
        (d / src.name).write_text(text.replace(old, new))
        so = d / "libgqa_one_part.so"
        builds[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(d / src.name)],
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in builds.items():
        err = proc.communicate(timeout=600)[1]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} copy:\n{err}")
        lib = ctypes.CDLL(str(so))
        for fn in ("wmt_gqa_decode_attention", "wmt_gqa_cluster_room"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def phase_gqa_split() -> None:
    """Phase 29, run only when named: what K3 GQA's split operands buy, and
    the proof that GQA_FP32_TOL tells a sound kernel from one that lost a
    split. At every GQA_TIMED and GQA_CHECKED shape, int8 and int4, fp32
    outputs against the plain version: the kernel's worst row error over
    its max|ref|, and that of each copy of GQA_ONE_PART (the query's or the
    weights' lo part dropped). The kernel must stay within GQA_FP32_TOL at
    every shape, and each copy must pass it at some shape."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    libs = _gqa_one_part_libs()
    real = _build.lib()
    worst = dict.fromkeys(["kernel", *libs], 0.0)
    cases = [(8, 8, 128, pos, tq, t) for _, pos, tq, t in GQA_TIMED] + list(GQA_CHECKED)
    for bits in (8, 4):
        for n_kv, rep, hd, pos, tq, t in cases:
            q, cache, p, kw = _gqa_inputs(gen, n_kv, rep, hd, pos, tq, t, bits)
            ref = gq.gqa_decode_attention_plain(q, *cache, p, **kw)
            line = f"  gqa_split int{bits} KV={n_kv} rep={rep} hd={hd} pos={pos} Tq={tq} T={t}:"
            for name, lib in [("kernel", real), *libs.items()]:
                _build._lib = lib
                try:
                    err = _row_err(gq.gqa_decode_attention(q, *cache, p, **kw), ref)[1]
                finally:
                    _build._lib = real
                worst[name] = max(worst[name], err)
                line += f" {name} {err:.3e}"
            print(line)
            del cache, q
    print("  gqa_split worst row err / row max|ref| over the shapes: "
          + ", ".join(f"{name} {err:.3e}" for name, err in worst.items())
          + f" (GQA_FP32_TOL {GQA_FP32_TOL:.0e})")
    if not worst["kernel"] <= GQA_FP32_TOL:
        raise AssertionError(f"the kernel's worst row {worst['kernel']} > {GQA_FP32_TOL}")
    for name in libs:
        if not worst[name] > GQA_FP32_TOL:
            raise AssertionError(f"{name}: worst row {worst[name]} within {GQA_FP32_TOL}: the "
                                 "limit does not see the lost part")


# ---------------------------------------------------------------------------
# the probes (K10-K12) and whisper from a 4-bit checkpoint
# ---------------------------------------------------------------------------

PROBE_ROWS = 24  # the probes' default batch
QUANT_VARIANTS = {  # K10a-g: name -> (row key, TPU function's line)
    "accum": ("probe_accum", 78), "e1": ("probe_e1", 232), "e2": ("probe_e2", 247),
    "e3": ("probe_e3", 281), "e5": ("probe_e5", 370), "e6": ("probe_e6", 446),
    "e7": ("probe_e7", 558)}


# K10 variant -> its name among the probe's own closures (make_variants)
PROBE_FN = {"accum": "accum", "e1": "e1", "e2": "e2", "e3": "e3", "e5": "e5",
            "e6": "e6-t256", "e7": "e7-t256"}


def _variant_plain(name, x, q):
    """The variant's plain version on the card's tensors (the wrapper would
    launch the kernel there), over operands made from ``q`` as the probe
    makes them."""
    kw = {}
    if name in ("e2", "e3"):
        kw["scale_w"], bias_w = pqm.make_scale_words(q)
        if name == "e2":
            kw["bias_w"] = bias_w
    if name in ("e3", "e6", "e7"):
        kw["xg"] = pqm.group_sums(x, q.group_size, in_fp32=name != "e3")
    w = {"e5": lambda: pqm.repack_strided(q).w_q, "e7": lambda: q.w_q.T.contiguous()}.get(
        name, lambda: q.w_q)()
    return pqm.variant_plain(name, x, w, q.scales, q.biases, q.bits, q.group_size, **kw)


def _variant_bytes(name, q, m) -> int:
    """Bytes the variant must move: its weight words, the affines it reads
    (c: two bf16 per-word tables, d: one and the raw biases), x, xg, out."""
    n, k = q.shape
    words, affine = _nbytes(q.w_q), _nbytes(q.scales)
    table = q.w_q.numel() * 2
    weights = {"e2": words + 2 * table, "e3": words + table + affine}.get(
        name, words + 2 * affine)
    xg = m * (k // q.group_size) * 2 if name in ("e3", "e6", "e7") else 0
    return weights + 2 * m * (k + n) + xg


def phase_probe_kernels() -> dict:
    """K10a-g at the five large-v3 decode-step shapes (24 rows, bf16, int4
    group 64) against their plain versions and against K5 on the same
    weights, with L2 cold as a decode step finds each layer; K11 at the
    cross and self shapes against its plain version and K3 on the same
    codes; K12's five stages. Returns the JSON rows."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    m = PROBE_ROWS
    sums = {name: dict(ms=0.0, plain=0.0, nbytes=0, err=0.0, k5=0.0) for name in QUANT_VARIANTS}
    lib_ms = k5_ms = ops = 0.0
    for k, n, label in bench_quant_kernel.SHAPES:
        q = tq.quantize(torch.randn((n, k), generator=gen, device=dev) * 0.02, 4, 64)
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        fns = bench_quant_kernel.make_variants(q)  # each closes over its own operands
        nbytes = _nbytes(q.w_q, q.scales, q.biases)
        packed = _layer_copies(lambda: dataclasses.replace(
            q, w_q=q.w_q.clone(), scales=q.scales.clone(), biases=q.biases.clone()), nbytes)
        copies = [bench_quant_kernel.make_variants(c) for c in packed]
        w_bf = [c.dequantize(torch.bfloat16) for c in packed]
        ref5 = tq.quant_matmul(x, q).float()
        scale = max(1.0, ref5.abs().max().item())
        line = []
        for name, s in sums.items():
            got, ref = fns[PROBE_FN[name]](x), _variant_plain(name, x, q)
            tol = QMM_TOL * max(1.0, ref.float().abs().max().item())
            s["err"] = max(s["err"], _check(f"probe {name} {label} K={k} N={n} M={m}", got, ref, tol))
            rel5 = float((got.float() - ref5).abs().max() / ref5.abs().max())
            s["k5"] = max(s["k5"], rel5)
            if name != "e7" and rel5 > 2e-2:
                raise AssertionError(f"probe {name} {label}: rel err {rel5} against K5")
            del got, ref
            ms = _cold_ms(lambda c: c[PROBE_FN[name]](x), copies)
            s["ms"] += ms
            s["plain"] += _device_ms(lambda: _variant_plain(name, x, q), reps=3, warmup=1)
            s["nbytes"] += _variant_bytes(name, q, m)
            line.append(f"{name} {ms * 1e3:.1f} us (vs K5 {rel5:.1e})")
        k5 = _cold_ms(lambda c: tq.quant_matmul(x, c), packed)
        lib = _cold_ms(lambda w: torch.matmul(x, w.T), w_bf)
        k5_ms, lib_ms, ops = k5_ms + k5, lib_ms + lib, ops + 2 * m * n * k
        print(f"    {label} at {m} rows, L2 cold: " + ", ".join(line)
              + f"; K5 {k5 * 1e3:.1f} us, bf16 torch.matmul {lib * 1e3:.1f} us")
        if label == "qkv-fused":  # the other side of K5's GEMV / tiled switch: 8 rows
            x8 = x[:8].contiguous()
            ref8 = tq.quant_matmul(x8, q).float()
            for name in sums:
                got = fns[PROBE_FN[name]](x8)
                _check(f"probe {name} {label} M=8", got, _variant_plain(name, x8, q),
                       QMM_TOL * scale)
                rel8 = float((got.float() - ref8).abs().max() / ref8.abs().max())
                assert name == "e7" or rel8 <= 2e-2, f"probe {name} M=8: {rel8} against K5"
        del copies, packed, w_bf, fns
        torch.cuda.empty_cache()
    print(f"  K10 over the five shapes at {m} rows: K5 {k5_ms:.4f} ms, bf16 torch.matmul "
          f"{lib_ms:.4f} ms; e7's error against K5 {sums['e7']['k5']:.3f} (relative: the "
          "reference parks it as unsound in bf16)")
    rows = {}
    for name, (key, line_no) in QUANT_VARIANTS.items():
        s = sums[name]
        rows[key] = dict(
            name=f"probe_quant_matmul_{name}", route="cuda",
            source="whisper_mlx_tpu_torch/csrc/probe_quant_matmul.cu",
            replaces=f"scripts/bench_quant_kernel.py:{line_no}", max_abs_err=s["err"],
            ms=s["ms"], plain_ms=s["plain"], **_bound(s["nbytes"], ops, "bf16"),
            library_ms=lib_ms, rel_err_vs_k5=s["k5"])
    rows.update(_probe_attention_kernels(gen))
    for key, r in rows.items():
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), library "
              + (f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None else "none"))
    return rows


def _probe_attention_kernels(gen) -> dict:
    """K11 and K12 at the probes' shapes: B 24, H 20, hd 64."""
    dev = gen.device
    b, h = PROBE_ROWS, 20
    rows = {}
    ms = plain = nbytes = ops = 0.0
    errs = []
    for label, tk_real, causal, pos in bench_decode_attention.CASES:
        tk = -(-tk_real // 128) * 128
        k8, ks = quantize_kv(torch.randn((b, h, tk, 64), generator=gen, device=dev))
        v8, vs = quantize_kv(torch.randn((b, h, tk, 64), generator=gen, device=dev))
        q = (torch.randn((b, h, 1, 64), generator=gen, device=dev) * 0.2).to(torch.bfloat16)
        kw = dict(pos=pos, causal=causal, valid_len=tk_real)

        def layer():
            return (k8.transpose(2, 3).contiguous(), ks.float(), v8.clone(), vs.float())

        c0 = layer()
        ref = pda.batched_attention_plain(q, *c0, **kw)
        tol = ATTN_TOL * max(1.0, ref.float().abs().max().item())
        for tile in (8, 16, 32):
            got = pda.batched_attention(q, *c0, bh_tile=tile, **kw)
            errs.append(_check(f"batched_attention {label} Tk={tk} bh_tile={tile}", got, ref, tol))
        _check(f"batched_attention {label} against K3 on the same codes", got,
               da.decode_attention(q, k8, ks, v8, vs, **kw), tol)
        copies = _layer_copies(layer, _nbytes(*c0))
        times = {tile: _cold_ms(lambda c: pda.batched_attention(q, *c, bh_tile=tile, **kw), copies)
                 for tile in (8, 16, 32)}
        k3_copies = _layer_copies(lambda: (k8.clone(), ks.clone(), v8.clone(), vs.clone()),
                                  _nbytes(k8, ks, v8, vs))
        k3 = _cold_ms(lambda c: da.decode_attention(q, *c, **kw), k3_copies)
        live = pos + 1 if causal else tk_real
        print(f"    {label} Tk={tk} ({live} live keys): K11 "
              + ", ".join(f"bh_tile {t} {v * 1e3:.1f} us" for t, v in times.items())
              + f"; K3 {k3 * 1e3:.1f} us")
        ms += times[16]
        plain += _cold_ms(lambda c: pda.batched_attention_plain(q, *c, **kw), copies, reps=8)
        # the live positions once: K and V codes, both fp32 scales; q in, out
        nbytes += b * h * live * (64 + 64 + 4 + 4) + 2 * _nbytes(q)
        ops += b * h * live * 2 * 2 * 64
        del copies, k3_copies
    rows["probe_batched"] = dict(
        name="probe_batched_attention", route="cuda",
        source="whisper_mlx_tpu_torch/csrc/probe_decode_attention.cu",
        replaces="scripts/bench_decode_attention.py:87", max_abs_err=max(errs), ms=ms,
        plain_ms=plain, **_bound(nbytes, ops, "fp32"), library_ms=None)

    bh, tk, tile = b * h, bench_da_ablation.TK, 16
    q = (torch.randn((bh, 1, 64), generator=gen, device=dev) * 0.1).to(torch.bfloat16)

    def blocks():
        return tuple(torch.randint(-127, 128, (bh, 64, tk), generator=gen, device=dev,
                                   dtype=torch.int8) for _ in range(2))

    copies = [blocks() for _ in range(3)]  # 94 MB each (47 MB of K): past the L2 at every stage
    for stage in pda.STAGES:
        got = pda.ablation_stage(q, *copies[0], stage, tile)
        ref = pda.ablation_stage_plain(q, *copies[0], stage)
        err = _check(f"ablation stage {stage} bh_tile={tile}", got, ref,
                     ATTN_TOL * max(1.0, ref.float().abs().max().item()))
        moved = (1 if stage == "dmak" else 2) * bh * 64 * tk
        rows[f"probe_{stage}"] = dict(
            name=f"probe_ablation_{stage}", route="cuda",
            source="whisper_mlx_tpu_torch/csrc/probe_decode_attention.cu",
            replaces="scripts/bench_da_ablation.py:65", max_abs_err=err,
            ms=_cold_ms(lambda c: pda.ablation_stage(q, *c, stage, tile), copies),
            plain_ms=_cold_ms(lambda c: pda.ablation_stage_plain(q, *c, stage), copies, reps=8),
            # the blocks the stage moves, q in and out; both dots from `dots` on
            **_bound(moved + 2 * _nbytes(q),
                     bh * tk * 2 * 2 * 64 if stage in ("dots", "full") else 0, "fp32"),
            library_ms=None)
    return rows


def phase_probe_mains() -> dict:
    """The three probe entry points, each once through its main() as
    ``python -m whisper_mlx_tpu_torch.probes.<name>`` runs it. Returns the
    launches of K10a-g, K11 and K12's stages over these runs."""
    for name in pqm.LAUNCHES:
        pqm.LAUNCHES[name] = 0
    for stage in pda.STAGE_LAUNCHES:
        pda.STAGE_LAUNCHES[stage] = 0
    pda.LAUNCHES = 0
    for probe in (bench_quant_kernel, bench_decode_attention, bench_da_ablation):
        print(f"  python -m {probe.__name__}:")
        rc = probe.main([])
        assert rc == 0, f"{probe.__name__} returned {rc}"
    torch.cuda.synchronize()
    launches = {QUANT_VARIANTS[name][0]: n for name, n in pqm.LAUNCHES.items()}
    launches["probe_batched"] = pda.LAUNCHES
    launches.update({f"probe_{stage}": n for stage, n in pda.STAGE_LAUNCHES.items()})
    print(f"  launches over the three probes: {launches}")
    for key, n in launches.items():
        assert n > 0, f"kernel {key} was not launched by its probe"
    return launches


QUANT4 = {"bits": 4, "group_size": 64}


def phase_tiny_quant() -> None:
    """The tiny config quantized by quantize_params, exported by
    export_mlx_whisper and loaded by load_mlx_whisper on both devices (bf16
    serving config): prefill logits card (K2, K3, K5) vs CPU (plain
    versions), then greedy token agreement."""
    cpu, dev = torch.device("cpu"), torch.device("cuda")
    base = WHISPER_CONFIGS["tiny"]
    tok = _bench_tokenizer(base.n_vocab)
    rng = np.random.default_rng(1)
    t = np.arange(N_SAMPLES) / 16000.0
    audio = np.stack([(0.3 * np.sin(2 * np.pi * (150 + 100 * i) * t)
                       * (1 + np.sin(2 * np.pi * 2.5 * t))
                       + 0.02 * rng.standard_normal(N_SAMPLES)).astype(np.float32)
                      for i in range(2)])
    mel = torch.stack([log_mel_spectrogram(torch.from_numpy(a), base.n_mels) for a in audio])
    logits, trees = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        export_mlx_whisper(tq.quantize_params(init_params(base, seed=0), **QUANT4), base, tmp,
                           quantization=QUANT4)
        for device in (cpu, dev):
            params, config = load_mlx_whisper(tmp, device=device)
            trees[device.type], config = apply_asr_serving_config(params, config, dev)
    attn = trees["cuda"]["decoder"]["blocks"][0]["attn"]
    print(f"tiny 4-bit: {attn['qkv']['w']!r} fused qkv, bias {attn['qkv']['b'].dtype}, token "
          f"table {trees['cuda']['decoder']['token_emb']!r}")
    before = qm.LAUNCHES
    with torch.inference_mode():
        for device in (cpu, dev):
            params = trees[device.type]
            states = encode(params, mel.to(device), config)
            init = torch.tensor([tok.sot_sequence] * 2, device=device)
            out, _ = decode_step(params, init, 0, init_kv_cache(config, 2, device, 8),
                                 cross_kv(params, states, config), config)
            logits[device.type] = out.float().cpu()
    assert qm.LAUNCHES > before, "the packed prefill did not launch K5"
    ref = logits["cpu"]
    _check("tiny 4-bit prefill logits cuda vs cpu", logits["cuda"], ref,
           TINY_LOGIT_TOL * max(1.0, ref.abs().max().item()))
    opts = DecodingOptions(sample_len=32)
    same, total = _agreement(decode(trees["cpu"], mel, tok, config, opts),
                             decode(trees["cuda"], mel.to(dev), tok, config, opts))
    print(f"  tiny 4-bit token agreement: {same}/{total}")


def _zero_whisper_counts() -> None:
    _zero_counts()
    dn.FAST_LAUNCHES = qm.LAUNCHES = mb.LAUNCHES = qm.TILED_LAUNCHES = mb.TILED_LAUNCHES = 0


def _whisper_counts() -> dict:
    return {"mel": mk.LAUNCHES, "dense": dn.LAUNCHES, "decode": da.LAUNCHES,
            "decode_int": da.INT_DOT_LAUNCHES, "beamflat": bf.LAUNCHES, "quant": qm.LAUNCHES,
            "mbt": mb.LAUNCHES, "quant_tiled": qm.TILED_LAUNCHES, "mbt_tiled": mb.TILED_LAUNCHES}


def _timed_decode(label, params, config, tok, audio, opts, runs: int = 2):
    """A 16-step warm-up (the policy's conversion, cuBLAS handles, the
    allocator), then ``runs`` timed passes of log_mel_spectrogram ->
    decode() over the windows in ``audio``; prints the rate and the launches
    of one pass; returns the last pass's results."""
    def pipeline(options):
        mel = torch.stack([log_mel_spectrogram(a, config.n_mels) for a in audio])
        return decode(params, mel, tok, config, options)

    with torch.inference_mode():
        pipeline(dataclasses.replace(opts, sample_len=16))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(runs):
        _zero_whisper_counts()
        t0 = time.perf_counter()
        with torch.inference_mode():
            results = pipeline(opts)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    best = min(times)
    rows = audio.shape[0] * (opts.beam_size or 1)
    print(f"{label}: {audio.shape[0]} windows x 30 s, {rows} rows, sample_len {opts.sample_len}: "
          f"{times} s (best {best:.3f} s), {sum(len(r.tokens) for r in results)} tokens, "
          f"{audio.shape[0] * 30.0 / best:.2f} audio-s/s; launches {_whisper_counts()}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return results


def _check_whisper_linears(params) -> dict:
    """K5 and K6 against their plain versions at the shapes the 4-bit main
    path gives them: the loaded tree's own leaves (fused qkv 1280 -> 3840,
    o 1280 -> 1280, fc1 1280 -> 5120, fc2 5120 -> 1280 and the ragged
    logits 1280 -> 51866, which K6's policy leaves packed) at 1 and 8 rows
    (a decode step of the CLI and of the 8-window batch) and 3 and 24 (their
    prefills). K6's leaves are those that prepare_mbt_params makes of them.
    Returns the largest error of each kernel."""
    block = params["decoder"]["blocks"][0]
    leaves = {"qkv": block["attn"]["qkv"]["w"], "o": block["attn"]["o"]["w"],
              "fc1": block["mlp"]["fc1"]["w"], "fc2": block["mlp"]["fc2"]["w"],
              "logits": params["decoder"]["token_emb"]}
    transposed = tq.prepare_mbt_params({"decoder": {"token_emb": leaves["logits"]},
                                        **{k: v for k, v in leaves.items() if k != "logits"}})
    assert isinstance(transposed["decoder"]["token_emb"], tq.QuantTensor)
    gen = torch.Generator(device="cuda").manual_seed(14)
    errs = {"quant_err": 0.0, "mbt_err": 0.0}
    for label, q in leaves.items():
        assert isinstance(q, tq.QuantTensor), f"{label}: {type(q).__name__}"
        n, k = q.shape
        for m in (1, 3, 8, 24):
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            ref = qm.quant_matmul_plain(x, q.w_q, q.scales, q.biases, q.bits, q.group_size)
            tol = QMM_TOL * max(1.0, ref.float().abs().max().item())
            errs["quant_err"] = max(errs["quant_err"], _check(
                f"quant_matmul whisper {label} N={n} K={k} M={m}", tq.quant_matmul(x, q), ref, tol))
            if label == "logits":
                continue
            qt = transposed[label]
            assert isinstance(qt, mb.QuantTensorT), f"{label}: {type(qt).__name__}"
            ref = mb.quant_matmul_mbt_plain(x, qt)
            tol = QMM_TOL * max(1.0, ref.float().abs().max().item())
            errs["mbt_err"] = max(errs["mbt_err"], _check(
                f"quant_matmul_mbt whisper {label} N={n} K={k} M={m}", tq.quant_matmul(x, qt),
                ref, tol))
    return errs


def _time_whisper_step_linears(params, config) -> dict:
    """K5 at 1 and 8 rows on the loaded large-v3 leaves, L2 cold, summed over
    a decode step (each block's six linears x n_text_layer, plus the logits),
    beside a yardstick: bf16 torch.matmul on the same leaves dequantized
    once. The yardstick reads 4x the bytes and is not K5's function, so it
    stays out of the ``library_ms`` field. Returns K5's 8-row step in ms."""
    block = params["decoder"]["blocks"][0]
    layers = config.n_text_layer
    leaves = [(block["attn"]["qkv"]["w"], layers), (block["attn"]["o"]["w"], layers),
              (block["cross_attn"]["q"]["w"], layers), (block["cross_attn"]["o"]["w"], layers),
              (block["mlp"]["fc1"]["w"], layers), (block["mlp"]["fc2"]["w"], layers),
              (params["decoder"]["token_emb"], 1)]
    gen = torch.Generator(device="cuda").manual_seed(15)
    sums = {m: [0.0, 0.0, 0] for m in (1, 8)}  # K5 ms, yardstick ms, bytes
    for q, count in leaves:
        assert isinstance(q, tq.QuantTensor), type(q).__name__
        n, k = q.shape
        nbytes = _nbytes(q.w_q, q.scales, q.biases)
        packed = _layer_copies(lambda: dataclasses.replace(
            q, w_q=q.w_q.clone(), scales=q.scales.clone(), biases=q.biases.clone()), nbytes)
        dense = [c.dequantize(torch.bfloat16) for c in packed]
        line = []
        for m in (1, 8):
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            k5 = _cold_ms(lambda c: tq.quant_matmul(x, c), packed)
            lib = _cold_ms(lambda w: torch.matmul(x, w.T), dense)
            sums[m][0] += count * k5
            sums[m][1] += count * lib
            sums[m][2] += count * (nbytes + 2 * m * (n + k))
            line.append(f"{m} row(s) K5 {k5 * 1e3:.1f} us ({nbytes / k5 / 1e6:.0f} GB/s), "
                        f"yardstick {lib * 1e3:.1f} us")
            if m == 8 and count == 1:
                host = _host_us(lambda: tq.quant_matmul(x, q))
        print(f"    large-v3 leaf N={n} K={k} (x{count} a step), L2 cold: " + "; ".join(line))
        del packed, dense
    for m, (k5, lib, nbytes) in sums.items():
        print(f"  K5 on a large-v3 decode step at {m} row(s) ({6 * layers + 1} calls, L2 cold): "
              f"{k5:.4f} ms, bound {_bound(nbytes, 0, 'bf16')['bound_ms']:.4f} ms (bytes); "
              f"yardstick, bf16 torch.matmul on the leaves dequantized once (4x the bytes, "
              f"not the same function): {lib:.4f} ms")
    print(f"  K5 host cost at 8 rows on the logits: {host:.1f} us a call")
    return {"quant_step_8rows_ms": sums[8][0]}


def _tokens(results) -> list:
    return [r.tokens for r in results]


def phase_quant_main_path() -> dict:
    """Whisper large-v3 at full width from a 4-bit mlx-format checkpoint
    written here (phase 15 of the module docstring). Returns the launch
    counts of the 4-bit path: K1, K2, K3 and K5 on the CLI run, K6 under
    WTPU_FEWROW_MBT=1, K2's bf16-softmax mode."""
    dev = torch.device("cuda")
    base = WHISPER_CONFIGS["large-v3"]
    tok = _bench_tokenizer(base.n_vocab)
    audio = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, N_SAMPLES)).astype(np.float32) * 0.1).to(dev)
    greedy = DecodingOptions(sample_len=BATCH_SAMPLE_LEN, without_timestamps=False)
    beam = DecodingOptions(sample_len=BATCH_SAMPLE_LEN, beam_size=5, without_timestamps=False)

    def load(**kw):
        return apply_asr_serving_config(*load_mlx_whisper(ckpt, device=dev, **kw), dev)

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "whisper-large-v3-4bit")
        t0 = time.perf_counter()
        export_mlx_whisper(
            tq.quantize_params(init_params(base, seed=0, device=dev, dtype=torch.bfloat16),
                               **QUANT4), base, ckpt, quantization=QUANT4)
        size = os.path.getsize(os.path.join(ckpt, "weights.safetensors"))
        print(f"4-bit checkpoint: large-v3 bf16 weights from seed 0 quantized on the card and "
              f"written in {time.perf_counter() - t0:.2f} s, {size / 2**20:.0f} MiB")
        torch.cuda.empty_cache()

        # (a) the CLI on the 65 s WAV. Random weights fail every fallback
        # threshold, so each window walks the ladder, cut to two rungs to
        # keep the run short: 1 row at T = 0, then best_of 5 -> 5 rows at
        # 1.0. All stay packed (<= 16 rows), so no conversion is cached.
        wav = os.path.join(tmp, "clip.wav")
        _write_wav(wav, 65.0)
        _zero_whisper_counts()
        t0 = time.perf_counter()
        rc = cli.main([wav, "-f", "txt", "--output-name", "out", "-o", tmp, "--model", ckpt,
                       "--condition-on-previous-text", "False", "--verbose", "False",
                       "--temperature-increment-on-fallback", "1.0"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _whisper_counts()
        assert not tq._DENSE_DECODE_CACHE, "a run of at most 5 rows converted the packed tree"
        assert rc == 0 and os.path.exists(os.path.join(tmp, "out.txt")), "CLI wrote no .txt"
        print(f"4-bit main path: CLI --model <mlx 4-bit dir> on a 65 s WAV in {seconds:.2f} s; "
              f"launches {launches}")
        for key in ("mel", "dense", "decode", "quant"):
            assert launches[key] > 0, f"kernel {key} was not launched on the 4-bit CLI run"
        assert launches["mbt"] == 0
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

        t0 = time.perf_counter()
        params, config = load()
        torch.cuda.synchronize()
        print(f"  load_mlx_whisper onto the card: {time.perf_counter() - t0:.2f} s, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        attn = params["decoder"]["blocks"][0]["attn"]
        assert isinstance(attn["qkv"]["w"], tq.QuantTensor)
        assert attn["qkv"]["b"].dtype == torch.bfloat16
        with torch.inference_mode():
            mel = torch.stack([log_mel_spectrogram(a, config.n_mels) for a in audio])
            states = encode(params, mel[:1], config)
            cache = init_kv_cache(config, 1, dev, 8)
            xkv = cross_kv(params, states, config)
            logits, _ = decode_step(params, torch.tensor([tok.sot_sequence], device=dev), 0,
                                    cache, xkv, config)
            assert torch.isfinite(logits).all(), "non-finite 4-bit large-v3 logits"
            before = qm.LAUNCHES
            decode_step(params, torch.full((1, 1), tok.timestamp_begin, device=dev), 3, cache,
                        xkv, config)
            per_step = qm.LAUNCHES - before
        print(f"  K5 launches in one decode step: {per_step} (6 linears x 32 layers + the logits)")
        assert per_step == 6 * config.n_text_layer + 1, per_step
        del states, cache, xkv, logits
        launches.update(_check_whisper_linears(params))  # after the CLI run's counts were read
        launches.update(_time_whisper_step_linears(params, config))
        torch.cuda.empty_cache()

        # (b) 8 windows greedy: 8 rows, packed, K5's GEMV at its widest
        res_packed = _timed_decode("4-bit batch (packed, K5)", params, config, tok, audio, greedy,
                                   runs=1)
        assert qm.LAUNCHES > 0 and mb.LAUNCHES == 0
        _breakdown(params, config, tok, audio)

        # (c) the same under WTPU_FEWROW_MBT=1: the tree transposed once, K6
        os.environ["WTPU_FEWROW_MBT"] = "1"
        try:
            res_mbt = _timed_decode("4-bit batch (WTPU_FEWROW_MBT=1, K6)", params, config, tok,
                                    audio, greedy, runs=1)
            launches["mbt"] = mb.LAUNCHES
            assert mb.LAUNCHES > 0, "K6 was not launched under WTPU_FEWROW_MBT=1"
            assert len(tq._DENSE_DECODE_CACHE) == 1, "the warm-up's conversion was not reused"
            same, total = _agreement(res_packed, res_mbt)
            print(f"  tokens agree with the packed run {same}/{total}")
            _breakdown(tq.maybe_dense_decode_params(params, 8, config.dtype), config, tok, audio)
        finally:
            del os.environ["WTPU_FEWROW_MBT"]
            tq._DENSE_DECODE_CACHE.clear()

        # (d) 8 windows x beam 5: 40 rows, the dense route (unfused, dequantized once)
        res_beam = _timed_decode("4-bit beam batch (dense route)", params, config, tok, audio,
                                 beam, runs=1)
        assert qm.LAUNCHES == 0 and mb.LAUNCHES == 0, "the 40-row route launched K5 or K6"
        assert len(tq._DENSE_DECODE_CACHE) == 1, "the warm-up's conversion was not reused"
        print(f"  policy cache: {len(tq._DENSE_DECODE_CACHE)} conversion(s); "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated with the packed and "
              "the dense tree on the card")
        tq._DENSE_DECODE_CACHE.clear()
        dense = tq.dequantize_params(load(fuse_qkv=False)[0], torch.bfloat16)
        _encoder_dequant_cost(params, dense, config, mel)
        res_dense = _timed_decode("the same model dequantized up front", dense, config, tok,
                                  audio, beam, runs=1)
        assert _tokens(res_beam) == _tokens(res_dense), \
            "the 40-row route's tokens differ from the model dequantized up front"
        print(f"  beam tokens equal the model dequantized up front: "
              f"{sum(len(t) for t in _tokens(res_beam))} tokens")

        # (e) WTPU_DEQUANT_AT_LOAD=1: dense at load, greedy tokens equal (d)'s dense model
        os.environ["WTPU_DEQUANT_AT_LOAD"] = "1"
        try:
            at_load, _ = load()
        finally:
            del os.environ["WTPU_DEQUANT_AT_LOAD"]
    assert not isinstance(at_load["decoder"]["token_emb"], tq.QuantTensor)
    short = DecodingOptions(sample_len=64, without_timestamps=False)
    with torch.inference_mode():
        _zero_whisper_counts()
        a, b = decode(at_load, mel, tok, config, short), decode(dense, mel, tok, config, short)
    assert qm.LAUNCHES == 0 and _tokens(a) == _tokens(b), \
        "WTPU_DEQUANT_AT_LOAD=1 tokens differ from the dequantized model"
    print(f"  WTPU_DEQUANT_AT_LOAD=1: greedy tokens equal the dequantized model "
          f"({sum(len(t) for t in _tokens(a))} tokens, no K5 launch)")
    del at_load, dense

    # (f) K2's bf16-softmax mode on the 8-window encode
    os.environ["WTPU_DENSE_SOFTMAX"] = "bf16"
    try:
        dn.FAST_LAUNCHES = 0
        with torch.inference_mode():
            fast = encode(params, mel, config)
        torch.cuda.synchronize()
        launches["dense_fast"] = dn.FAST_LAUNCHES
    finally:
        del os.environ["WTPU_DENSE_SOFTMAX"]
    with torch.inference_mode():
        exact = encode(params, mel, config)
    diff = (fast.float() - exact.float()).abs().max().item()
    print(f"  WTPU_DENSE_SOFTMAX=bf16: {launches['dense_fast']} K2 launches in that mode on the "
          f"8-window encode; encoder states differ from the exact softmax by {diff:.3e} "
          f"(|states| max {exact.float().abs().max().item():.3e})")
    assert launches["dense_fast"] == config.n_audio_layer and torch.isfinite(fast).all()
    return launches


def _prefill_rates(params, config, label: str, lengths=(128, 384, 512)) -> None:
    """Prefill tok/s at each length: one warm-up pass, then the best of two."""
    for t in lengths:
        _prefill_ms(params, config, t)
        ms = min(_prefill_ms(params, config, t) for _ in range(2))
        print(f"  prefill {label} T={t}: {ms:.2f} ms, {t / ms * 1e3:.1f} tok/s")


def phase_tiled_times() -> None:
    """Phase 20, run only when named: the tiled core (K5; K6 packed and
    codes-resident) over one Qwen3-32B layer's four linears at 128, 384 and
    512 rows and over large-v3's five decode matmuls at 24 rows, L2 cold,
    each beside its yardstick and bound; then Qwen3-32B's prefill at 128,
    384 and 512 tokens (64 layers packed, then 16 under
    WTPU_MBT_RESIDENT=1). No check of one tree's design, so that two trees
    run it in turn in one call."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    _tiled_layer(gen, lambda q: q, label="K5")
    _tiled_layer(gen, lambda q: mb.transpose_quant(q, codes=False), label="K6 packed")
    _tiled_layer(gen, lambda q: mb.transpose_quant(q, codes=True), m_values=(384,),
                 label="K6 codes-resident (down packed: K past 8192)")
    _tiled_whisper_step(gen)
    config = dataclasses.replace(QWEN32, dtype=torch.bfloat16, flash_attention=True)
    params = qw.init_random_quant_params(config, seed=0, device=dev)
    _prefill_rates(params, config, "packed, 64 layers")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    os.environ["WTPU_MBT_RESIDENT"] = "1"
    try:
        config = dataclasses.replace(config, num_hidden_layers=RESIDENCY_LAYERS)
        engine = LLMEngine(qw.init_random_quant_params(config, seed=0, device=dev), config,
                           _CountingTokenizer(), max_context=4096)
        _prefill_rates(engine.params, config, f"WTPU_MBT_RESIDENT=1, {RESIDENCY_LAYERS} layers")
        del engine
    finally:
        os.environ.pop("WTPU_MBT_RESIDENT", None)


def phase_batches() -> None:
    """Phase 16: the 8-window greedy batches of phases 5 (dense bf16) and 15
    (4-bit packed, K5), two timed runs each, each with its breakdown."""
    _time_batch(runs=2)
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    base = WHISPER_CONFIGS["large-v3"]
    audio = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, N_SAMPLES)).astype(np.float32) * 0.1).to(dev)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "whisper-large-v3-4bit")
        export_mlx_whisper(
            tq.quantize_params(init_params(base, seed=0, device=dev, dtype=torch.bfloat16),
                               **QUANT4), base, ckpt, quantization=QUANT4)
        torch.cuda.empty_cache()
        params, config = apply_asr_serving_config(*load_mlx_whisper(ckpt, device=dev), dev)
    tok = _bench_tokenizer(config.n_vocab)
    _timed_decode("4-bit batch (packed, K5)", params, config, tok, audio,
                  DecodingOptions(sample_len=224, without_timestamps=False), runs=2)
    _breakdown(params, config, tok, audio)


def phase_beam_times() -> None:
    """Phase 18: the beam kernels' times alone (K8 in every mode, width and
    ancestry, its split at every M15_FILLS value in both modes beside the
    flat mode at the same ancestry and its per-lane layout's four cases;
    K9's move at 8 and 32 lanes, its permute and index_select), through the
    wrappers' public calls and with no check of either tree's design, to
    set two trees side by side in one call (run in turn)."""
    times = _beam_kernel_times(_beam_timing_inputs())
    times.update(_m15_times(_m15_timing_inputs()))
    for label, ms in times.items():
        print(f"  beam kernel time {label}: {ms:.4f} ms")


def phase_beam_batches() -> None:
    """Phase 19: phase 6's dense 8-window x beam 5 batch, two timed runs
    with its per-step breakdown (device ms a step, K8's ms a step), for the
    same use."""
    dev = torch.device("cuda")
    base = WHISPER_CONFIGS["large-v3"]
    params, config = apply_asr_serving_config(
        init_params(base, seed=0, device=dev, dtype=torch.bfloat16), base, dev)
    rng = np.random.default_rng(3)
    audio = torch.from_numpy(rng.standard_normal((8, N_SAMPLES)).astype(np.float32) * 0.1).to(dev)
    _time_beam_batch(params, config, _bench_tokenizer(config.n_vocab), audio, runs=2)


# ---------------------------------------------------------------------------
# serving: the cross-request batcher and batched transcription with words
# ---------------------------------------------------------------------------

# the alignment pass's cross-attention weights, card vs CPU: at fp32 on the
# same encoder states (the route's plain ops, TF32 off), and end to end in
# the bf16 serving config (the card's encoder on K2, bf16 activations). The
# weights are near uniform (1/1500 = 6.7e-4 on random weights), so the bf16
# limit sits between the card's reading (9.8e-5 on the H100) and the two
# controls the phase prints and requires above it: the next window's
# weights (3.9e-4) and uniform weights (3.7e-3)
ALIGN_TOL_FP32 = 1e-5
ALIGN_TOL_BF16 = 2e-4


def _wordy_tokenizer(n_vocab: int):
    """The real special-token layout over a base vocabulary of the 256
    byte tokens and 50,001 four-letter ones, every other one opening a word,
    so that random weights' tokens decode to words (the byte-level
    _bench_tokenizer leaves most of them without text)."""
    vocab = {c: i for i, c in enumerate(bytes_to_unicode().values())}
    for i in range(50257 - 256):
        letters = "".join(chr(97 + (i // 26 ** k) % 26) for k in range(4))
        vocab[("\u0120" if i % 2 == 0 else "") + letters] = len(vocab)
    tok = WhisperTokenizer(ByteLevelBPE(vocab, []), n_base=50257,
                           num_languages=100 if n_vocab == 51866 else 99)
    assert tok.n_vocab == n_vocab, (tok.n_vocab, n_vocab)
    return tok


def _request_audio(seconds: float, seed: int) -> np.ndarray:
    """phase 4's synthetic audio: two tones under a 2.5 Hz envelope and noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    return (0.3 * np.sin(2 * np.pi * (150 + 100 * seed) * t) * (1 + np.sin(2 * np.pi * 2.5 * t))
            + 0.02 * rng.standard_normal(t.size)).astype(np.float32)


def _burst(batcher, audios, stream_index=None):
    """The requests at once, the one at ``stream_index`` (if any) through
    stream_transcribe. -> (results, that request's windows in arrival order)."""
    import asyncio

    async def streamed(audio):
        events = [ev async for ev in batcher.stream_transcribe(audio)]
        return ({"segments": [s for ev in events for s in ev["segments"]]},
                [ev["window"] for ev in events])

    async def run():
        out = await asyncio.gather(*(streamed(a) if i == stream_index else batcher.transcribe(a)
                                     for i, a in enumerate(audios)))
        batcher.shutdown()
        return out

    out = asyncio.run(run())
    if stream_index is None:
        return out, None
    out[stream_index], order = out[stream_index]
    return out, order


def _check_segments(results, seconds) -> int:
    """Every segment inside its request's span (its windows), every word
    with start <= end; -> the number of words."""
    words = 0
    for r, sec in zip(results, seconds):
        span = -(-sec // 30) * 30.0
        for s in r["segments"]:
            assert 0.0 <= s["start"] <= s["end"] <= span, (s["start"], s["end"], span)
            for w in s.get("words") or []:
                assert w["start"] <= w["end"], w
                words += 1
    return words


def _serve_tiny() -> None:
    """The tiny config in the serving config, card vs CPU: the batcher on
    three concurrent requests, prefill logits, the alignment weights, the
    words' times, and the batched transcribe with words."""
    cpu, dev = torch.device("cpu"), torch.device("cuda")
    base = WHISPER_CONFIGS["tiny"]
    params_cpu, config = apply_asr_serving_config(init_params(base, seed=0), base, dev)
    runs = (("cpu", cpu, params_cpu), ("cuda", dev, _to(params_cpu, dev)))
    tok = _wordy_tokenizer(config.n_vocab)
    seconds = (65.0, 20.0, 40.0)
    audios = [_request_audio(sec, i) for i, sec in enumerate(seconds)]

    def agreement(a, b) -> str:
        ta = [t for s in a["segments"] for t in s["tokens"]]
        tb = [t for s in b["segments"] for t in s["tokens"]]
        same = sum(x == y for x, y in zip(ta, tb))
        return f"cpu {len(ta)} tokens, cuda {len(tb)}; token agreement {same}/{max(len(ta), len(tb))}"

    results = {}
    for label, device, params in runs:
        b = TranscriptionBatcher(params, config, tok, device=device, batch_size=(2, 8),
                                 max_wait_ms=200, decoding=DecodingOptions(sample_len=64))
        results[label], _ = _burst(b, audios)
    for i, (a, b) in enumerate(zip(results["cpu"], results["cuda"])):
        print(f"  tiny batcher request {i} ({seconds[i]:.0f} s): {agreement(a, b)}")
    _check_segments(results["cuda"], seconds)

    # the 65 s request's mel windows (K1) and prefill logits, card vs CPU
    windows = {label: TranscriptionBatcher(p, config, tok, device=d)._windows(audios[0])
               for label, d, p in runs}
    _check("tiny batcher mel windows cuda vs cpu", windows["cuda"].cpu(), windows["cpu"], MEL_TOL)
    mel = windows["cpu"]
    logits = {}
    with torch.inference_mode():
        for label, device, params in runs:
            states = encode(params, mel.to(device), config)
            init = torch.tensor([tok.sot_sequence] * 3, device=device)
            out, _ = decode_step(params, init, 0, init_kv_cache(config, 3, device, 8),
                                 cross_kv(params, states, config), config)
            logits[label] = out.float().cpu()
    ref = logits["cpu"]
    _check("tiny serve prefill logits cuda vs cpu", logits["cuda"], ref,
           TINY_LOGIT_TOL * max(1.0, ref.abs().max().item()))

    # the alignment pass's weights, card vs CPU
    fp = dataclasses.replace(config, kv_bits=0, self_kv_bits=0)
    f32 = dataclasses.replace(fp, dtype=torch.float32)
    text = tok.encode(" the quick brown fox jumps over the lazy dog")
    tokens = list(tok.sot_sequence) + [tok.no_timestamps] + text + [tok.eot]
    weights = {}
    with torch.inference_mode():
        # the control: the CPU's weights of the next window (wrong states)
        st = encode(params_cpu, mel[1:2], fp)
        weights["control"] = decode_step(
            params_cpu, torch.tensor([tokens]), 0, init_kv_cache(fp, 1, cpu),
            cross_kv(params_cpu, st, fp), fp, collect_cross_attn=True)[2]
        states = encode(runs[1][2], mel[:1].to(dev), fp).float()
        p32 = init_params(f32, seed=0)
        for label, device, params in runs:
            p = _to(p32, device)
            out = decode_step(p, torch.tensor([tokens], device=device), 0,
                              init_kv_cache(f32, 1, device), cross_kv(p, states.to(device), f32),
                              f32, collect_cross_attn=True)
            weights[f"fp32_{label}"] = out[2].cpu()
            st = encode(params, mel[:1].to(device), fp)
            out = decode_step(params, torch.tensor([tokens], device=device), 0,
                              init_kv_cache(fp, 1, device), cross_kv(params, st, fp), fp,
                              collect_cross_attn=True)
            weights[f"bf16_{label}"] = out[2].cpu()
    for kind, tol in (("fp32", ALIGN_TOL_FP32), ("bf16", ALIGN_TOL_BF16)):
        got = weights[f"{kind}_cuda"]
        assert torch.isfinite(got).all(), f"non-finite {kind} alignment weights"
        _check(f"tiny alignment weights {kind} cuda vs cpu {tuple(got.shape)}", got,
               weights[f"{kind}_cpu"], tol)
    ref = weights["bf16_cpu"]
    for control, other in (("the next window's", weights["control"]),
                           ("uniform", torch.full_like(ref, 1.0 / ref.shape[-1]))):
        err = (other.float() - ref).abs().max().item()
        print(f"  control: {control} weights vs cpu: max_abs_err {err:.3e} "
              f"(must exceed {ALIGN_TOL_BF16:.0e})")
        assert err > ALIGN_TOL_BF16, f"the bf16 limit does not tell {control} weights apart"

    # the card's weights through the rest of the alignment (normalization,
    # the median filter on the card, DTW) give the path the CPU gives on the
    # same weights, exactly: the card adds no error after the weights
    heads = word_timestamps_mod.default_alignment_heads(config)
    w = torch.stack([weights["bf16_cuda"][l, 0, h] for l, h in heads]).numpy()
    paths = [word_timestamps_mod.alignment_path(w, 3000, n_skip_rows=len(tok.sot_sequence),
                                                device=d) for d in (dev, cpu)]
    assert all(np.array_equal(a, b) for a, b in zip(*paths)), "alignment paths differ"
    print(f"  tiny alignment path of the card's weights: median filter on the card equals "
          f"the CPU's ({len(paths[0][0])} steps)")

    # the words of the same text in the same window, card vs CPU
    words = {label: word_timestamps_mod.find_alignment(p, config, tok, text, mel[0].to(d),
                                                       num_frames=3000)
             for label, d, p in runs}
    assert len(words["cuda"]) == len(words["cpu"]) > 0, (len(words["cuda"]), len(words["cpu"]))
    d_start = max(abs(a.start - b.start) for a, b in zip(words["cuda"], words["cpu"]))
    d_end = max(abs(a.end - b.end) for a, b in zip(words["cuda"], words["cpu"]))
    # near-uniform random weights leave the DTW many near ties, so bf16
    # noise within the limit above moves words: printed, not bounded
    print(f"  tiny words of the same text: {len(words['cuda'])} on both, start times differ by "
          f"at most {d_start:.2f} s, end times by {d_end:.2f} s")

    # transcribe(batch_windows=True, word_timestamps=True) on the 65 s clip
    out = {label: transcribe_mod.transcribe(
        audios[0], params=p, config=config, tokenizer=tok, device=d, temperature=0.0,
        batch_windows=True, word_timestamps=True, no_speech_threshold=None, sample_len=64,
        language="en", verbose=False) for label, d, p in runs}
    n = {label: _check_segments([r], (65.0,)) for label, r in out.items()}
    print(f"  tiny batched transcribe with words (65 s): {agreement(out['cpu'], out['cuda'])}; "
          f"words cpu {n['cpu']}, cuda {n['cuda']}")
    assert n["cuda"] > 0, "no aligned word on the card"


def phase_serve() -> dict:
    """Phase 22: the tiny config card vs CPU (_serve_tiny), then large-v3 at
    full width (bf16, int4 cross, int8 self, random weights of seed 0): a
    burst of four requests through TranscriptionBatcher (one streamed), then
    transcribe(batch_windows=True, word_timestamps=True) with a two-rung
    ladder. Returns K1, K2 and K3's launches over the large-v3 runs."""
    from whisper_mlx_tpu_torch import native

    reader = (f"the C++ library ({native.library_path().name})" if native.load() is not None
              else "NumPy (no g++)")
    print(f"serve: WAV reader and DTW: {reader}; ffmpeg {shutil.which('ffmpeg') or 'absent'}; "
          f"aiohttp {'present' if importlib.util.find_spec('aiohttp') else 'absent'}")
    _serve_tiny()
    gc.collect()
    torch.cuda.empty_cache()

    dev = torch.device("cuda")
    base = WHISPER_CONFIGS["large-v3"]
    params, config = apply_asr_serving_config(
        init_params(base, seed=0, device=dev, dtype=torch.bfloat16), base, dev)
    tok = _wordy_tokenizer(config.n_vocab)
    seconds = (65.0, 30.0, 20.0, 65.0)  # 3 + 1 + 1 + 3 windows
    with tempfile.TemporaryDirectory() as tmp:
        wavs = []
        for i, sec in enumerate(seconds):
            wavs.append(os.path.join(tmp, f"req{i}.wav"))
            _write_wav(wavs[-1], sec)
        audios = [load_audio_serving(w) for w in wavs]  # 16-bit mono 16 kHz: int16
        assert all(a.dtype == np.int16 for a in audios)
        # warm-up: cuBLAS handles, the allocator, one short batch
        warm = TranscriptionBatcher(params, config, tok, device=dev,
                                    decoding=DecodingOptions(sample_len=8))
        _burst(warm, audios[2:3], stream_index=0)
        # buckets and flush from the serving knobs' defaults (8,16,32,56 on
        # CUDA; 50/25 ms)
        batcher = TranscriptionBatcher(params, config, tok, device=dev,
                                       decoding=DecodingOptions(sample_len=BATCH_SAMPLE_LEN))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        results, order = _burst(batcher, audios, stream_index=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        burst = {"mel": mk.LAUNCHES, "dense": dn.LAUNCHES, "decode": da.LAUNCHES}
        peak = torch.cuda.max_memory_allocated() / 2**30
        stats = batcher.stats
        assert order == [0, 1, 2], f"streamed windows out of order: {order}"
        assert stats["windows"] == 8, stats
        _check_segments(results, seconds)
        print(f"serve burst: large-v3 bf16 kv4/self8, {len(seconds)} requests "
              f"({', '.join(f'{s:.0f}' for s in seconds)} s, int16 upload), {stats['windows']} "
              f"windows, buckets {batcher.buckets}, flush {batcher.max_wait_ms:g}/"
              f"{batcher.idle_gap_ms:g} ms: {stats['batches']} "
              f"batches, fill {stats['fill_sum'] / stats['batches']:.3f}, wall {wall:.3f} s, "
              f"{sum(seconds) / wall:.2f} audio-s/s; streamed request windows {order}; "
              f"launches {burst}; peak memory {peak:.2f} GiB; "
              f"{sum(len(s['tokens']) for r in results for s in r['segments'])} tokens")

        # the largest default bucket once: one request of 56 windows
        # (1,675 s) rides one batch of 56, greedy to BIG_BUCKET_SAMPLE_LEN tokens
        big = TranscriptionBatcher(params, config, tok, device=dev,
                                   decoding=DecodingOptions(sample_len=BIG_BUCKET_SAMPLE_LEN))
        long_audio = _request_audio(1675.0, 4)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (long_result,), _ = _burst(big, [long_audio])
        torch.cuda.synchronize()
        wall_big = time.perf_counter() - t0
        assert big.stats["batches"] == 1 and big.stats["windows"] == 56, big.stats
        _check_segments([long_result], (1675.0,))
        print(f"serve bucket 56: one request of 1675 s, 56 windows in {big.stats['batches']} "
              f"batch (fill {big.stats['fill_sum']:.3f}), wall {wall_big:.3f} s, "
              f"{1675.0 / wall_big:.2f} audio-s/s, {56 / wall_big:.3f} windows/s "
              f"(the 8-window burst: {8 / wall:.3f}); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del big, long_audio, long_result
        gc.collect()
        torch.cuda.empty_cache()

        # the batched transcribe with words: random weights fail every
        # threshold at T = 0, so the retry rung decodes the 3 pending
        # windows (gathered to 4) at T = 1.0
        calls, cross_shapes = [], []
        real, real_step = transcribe_mod.decode, word_timestamps_mod.decode_step

        def spy(*a, **kw):
            calls.append((a[1].shape[0], a[4].temperature))
            return real(*a, **kw)

        def step_spy(*a, **kw):  # the alignment passes: every cross weight finite
            out = real_step(*a, **kw)
            assert torch.isfinite(out[2]).all(), "non-finite cross-attention weights"
            cross_shapes.append(tuple(out[2].shape))
            return out

        transcribe_mod.decode, word_timestamps_mod.decode_step = spy, step_spy
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        try:
            t0 = time.perf_counter()
            out = transcribe_mod.transcribe(
                wavs[0], params=params, config=config, tokenizer=tok, device=dev,
                temperature=(0.0, 1.0), batch_windows=True, word_timestamps=True,
                no_speech_threshold=None, language="en", verbose=False)
            torch.cuda.synchronize()
            wall_words = time.perf_counter() - t0
        finally:
            transcribe_mod.decode, word_timestamps_mod.decode_step = real, real_step
    words_launches = {"mel": mk.LAUNCHES, "dense": dn.LAUNCHES, "decode": da.LAUNCHES}
    n_words = _check_segments([out], (65.0,))
    stages = {k: v["total_ms"] for k, v in out["stages"].items()}
    print(f"serve alignment passes: cross-attention weights {cross_shapes}, all finite")
    print(f"serve batched transcribe with words: 65 s, 3 windows, rungs (rows, T) {calls}, "
          f"{len(out['segments'])} segments, {n_words} words, wall {wall_words:.3f} s "
          f"({65.0 / wall_words:.2f} audio-s/s), stages ms {stages}, launches {words_launches}, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    assert len(calls) == 2 and calls[0] == (8, 0.0) and calls[1][1] == 1.0 \
        and calls[1][0] <= 4, f"expected rung 0 over 8 rows, then the pending windows: {calls}"
    assert n_words > 0 and cross_shapes, "no aligned word"
    print(f"serve: {_smi()}")
    launches = {k: burst[k] + words_launches[k] for k in burst}
    for key, count in launches.items():
        assert burst[key] > 0 and words_launches[key] > 0, \
            f"kernel {key} was not launched on the serving path: {burst}, {words_launches}"
    return {f"{k}_serve": v for k, v in launches.items()}


# ---------------------------------------------------------------------------
# speculative decoding (ROADMAP M11): whisper draft-and-verify greedy and the
# LLM's draft model
# ---------------------------------------------------------------------------

SPEC_K = 4
# the tokens of phase 23's large-v3 runs (cut from 224, a window's whole
# horizon, to 128 and then 64 for the whole run's time limit)
SPEC_WHISPER_TOKENS = 64
# a flip of the argmax between a k + 1-row verify and a 1-row step needs the
# two tokens' gap within |d_a| + |d_b| <= 2 D, where D is the largest
# verify-vs-step logit difference; D is measured in the same run on the plain
# run's tokens (teacher-forced blocks of k + 1 against the plain run's own
# steps), so the limit is 2 D with half again for positions and cache
# histories that measurement did not see
SPEC_TIE_FACTOR = 3.0


class _StepSpy:
    """Every ``decode_step`` call of a module while in use, as (is the
    target, tokens, pos, logits); ``target`` is the target's params object,
    so a self-draft is passed as a shallow copy to tell the two apart."""

    def __init__(self, module, target):
        self.module, self.target, self.calls = module, target, []

    def __enter__(self):
        self.real = real = self.module.decode_step

        def spy(params, tokens, pos, *a, **kw):
            out = real(params, tokens, pos, *a, **kw)
            self.calls.append((params is self.target, tokens.clone(), pos, out[0]))
            return out

        self.module.decode_step = spy
        return self

    def __exit__(self, *exc):
        self.module.decode_step = self.real

    def draft_calls(self) -> int:
        return sum(not t for t, *_ in self.calls)


def _spec_counts() -> dict:
    return {"mel": mk.LAUNCHES, "dense": dn.LAUNCHES, "decode": da.LAUNCHES,
            "flash": fa.LAUNCHES, "quant": qm.LAUNCHES, "quant_tiled": qm.TILED_LAUNCHES}


def _spec_run(fn):
    """``fn()`` with every count at 0 before it and peak memory reset:
    (its result, wall s, launches of K1-K5, peak GiB)."""
    _zero_counts()
    fa.LAUNCHES = qm.LAUNCHES = qm.TILED_LAUNCHES = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, _spec_counts(), torch.cuda.max_memory_allocated() / 2**30


def _first_difference(a: list, b: list):
    """The first index where two token lists part (one ending counts), or None."""
    for i in range(max(len(a), len(b))):
        if i >= len(a) or i >= len(b) or a[i] != b[i]:
            return i
    return None


def _verify_vs_step(step_logits: list, verify) -> float:
    """D: the largest |logit| difference between the plain run's 1-row
    steps and teacher-forced verify blocks of k + 1 over its tokens.
    ``step_logits[j]`` is the plain run's (V,) logits for token j;
    ``verify(start)`` the block's (rows, V) logits for tokens start + 1 ..."""
    d = 0.0
    n = len(step_logits)
    for start in range(0, n - 1, SPEC_K + 1):
        rows = verify(start)
        for i in range(min(SPEC_K + 1, n - 1 - start)):
            d = max(d, (rows[i].float() - step_logits[start + 1 + i].float()).abs().max().item())
    return d


def _spec_check(label, plain: list, got: list, gap_at, d: float, rejections=None) -> None:
    """The phase's own check of one speculative run against the plain run:
    token agreement printed; at the first differing position the plain
    run's gap between the two tokens within SPEC_TIE_FACTOR * D; with a
    self-draft, every rejection before that position a near tie too
    (``rejections``: (token index, gap) of each)."""
    tol = SPEC_TIE_FACTOR * d
    first = _first_difference(plain, got)
    same = sum(x == y for x, y in zip(plain, got))
    msg = (f"    {label}: tokens agree with the plain run on {same}/{max(len(plain), len(got))}, "
           f"first difference at {first}; verify-vs-step D {d:.4e}, near-tie limit {tol:.4e}")
    if first is not None:
        gap = gap_at(first)
        msg += f"; the plain run's gap there {gap:.4e}"
        if not gap <= tol:
            raise AssertionError(f"{label}: tokens part at {first} with a gap of {gap} "
                                 f"> {tol} (D {d})")
    if rejections is not None:
        before = [(i, g) for i, g in rejections if first is None or i < first]
        msg += f"; self-draft rejections before it {len(before)}"
        for i, g in before:
            if not g <= tol:
                raise AssertionError(f"{label}: the self-draft rejected token {i} with a gap "
                                     f"of {g} > {tol}")
    print(msg)


def _rejections(spy_calls, tokens: list, index, gap) -> list:
    """(token index, gap) of each verify's first rejected proposal that
    stands for a committed token: ``index(pos, i)`` is the token index of
    proposal i of a verify at ``pos``, ``gap(row, j, a, b)`` the verify
    logits' gap between the target's token a and the proposal b."""
    out = []
    for is_target, toks, pos, logits in spy_calls[2:]:  # past both prefills
        if not is_target:
            continue
        for i in range(1, toks.shape[1]):
            j = index(pos, i)
            if j >= len(tokens):
                break
            if int(toks[0, i]) != tokens[j]:
                out.append((j, gap(logits[0, i - 1], j, tokens[j], int(toks[0, i]))))
                break
    return out


def _spec_tiny() -> None:
    """The tiny config card vs CPU: spec_decode_task with an identical and
    with a 1-layer draft beside greedy, the CLI with --draft-model, and
    speculative_generate on a tiny Qwen pair."""
    from whisper_mlx_tpu_torch.checkpoint.qwen_loader import load_qwen
    from whisper_mlx_tpu_torch.decoding.speculative import spec_decode_task
    from whisper_mlx_tpu_torch.inference.speculative import speculative_generate

    cpu, dev = torch.device("cpu"), torch.device("cuda")
    base = WHISPER_CONFIGS["tiny"]
    params_cpu, config = apply_asr_serving_config(init_params(base, seed=0), base, dev)
    dbase = dataclasses.replace(base, n_text_layer=1)
    draft_cpu, dconfig = apply_asr_serving_config(init_params(dbase, seed=1), dbase, dev)
    params_dev, draft_dev = _to(params_cpu, dev), _to(draft_cpu, dev)
    tok = _bench_tokenizer(config.n_vocab)
    rng = np.random.default_rng(1)
    t = np.arange(N_SAMPLES) / 16000.0
    mel = torch.stack([log_mel_spectrogram(torch.from_numpy(
        (0.3 * np.sin(2 * np.pi * (150 + 100 * i) * t) * (1 + np.sin(2 * np.pi * 2.5 * t))
         + 0.02 * rng.standard_normal(N_SAMPLES)).astype(np.float32)), config.n_mels)
        for i in range(2)])
    opts = DecodingOptions(sample_len=64)
    greedy = decode(params_dev, mel.to(dev), tok, config, opts)
    for label, d_cpu, d_dev, dcfg in (("identical draft", params_cpu, params_dev, config),
                                      ("1-layer draft", draft_cpu, draft_dev, dconfig)):
        res_cpu = spec_decode_task(params_cpu, d_cpu, mel, tok, config, dcfg, opts, k=SPEC_K)
        res_dev = spec_decode_task(params_dev, d_dev, mel.to(dev), tok, config, dcfg, opts,
                                   k=SPEC_K)
        for r in res_dev:
            assert r.tokens and 0 <= r.spec_stats["accepted"] <= r.spec_stats["proposed"]
        acc = [sum(r.spec_stats[key] for r in res) for res in (res_dev, res_cpu)
               for key in ("accepted", "proposed")]
        print(f"  spec tiny, {label}, k {SPEC_K}: card vs CPU {'%d/%d' % _agreement(res_dev, res_cpu)}"
              f" tokens, card spec vs card greedy {'%d/%d' % _agreement(res_dev, greedy)}; "
              f"accepted/proposed card {acc[0]}/{acc[1]}, CPU {acc[2]}/{acc[3]}")

    calls = []
    real = transcribe_mod.spec_decode_task
    transcribe_mod.spec_decode_task = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            wav = os.path.join(tmp, "short.wav")
            _write_wav(wav, 12.0)
            t0 = time.perf_counter()
            rc = cli.main([wav, "-f", "txt", "--output-name", "spec", "-o", tmp, "--model",
                           "tiny", "--draft-model", "tiny", "--spec-k", str(SPEC_K),
                           "--verbose", "False", "--condition-on-previous-text", "False",
                           "--temperature-increment-on-fallback", "None"])
            wall = time.perf_counter() - t0
            assert rc == 0 and os.path.exists(os.path.join(tmp, "spec.txt")), "CLI wrote no .txt"
    finally:
        transcribe_mod.spec_decode_task = real
    assert calls, "the CLI's --draft-model never ran spec_decode_task"
    print(f"  spec tiny CLI --draft-model tiny on a 12 s WAV: {wall:.2f} s, "
          f"{len(calls)} windows through spec_decode_task")

    with tempfile.TemporaryDirectory() as tmp:
        _write_tiny_qwen(tmp)
        os.environ["QWEN_DRAFT_PATH"] = tmp
        try:
            card = QwenModel(model_path=tmp, device="cuda").engine
        finally:
            del os.environ["QWEN_DRAFT_PATH"]
        assert card.draft is not None, "QWEN_DRAFT_PATH loaded no draft"
        target_cpu, qconfig = load_qwen(tmp, dtype=torch.bfloat16, device="cpu")
    qconfig = serving_config(qconfig, dev)
    dq = qw.QwenConfig(vocab_size=qconfig.vocab_size, hidden_size=128, intermediate_size=256,
                       num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
                       head_dim=64, qk_norm=True, attention_bias=False,
                       tie_word_embeddings=True, dtype=torch.bfloat16, flash_attention=True)
    dq_cpu = _to(qw.init_params(dq, seed=2), torch.bfloat16)
    prompt = list(np.random.default_rng(5).integers(0, 263, size=40))
    ids = [int(x) for x in prompt]
    out = {}
    for where, tp, dp in (("cpu", target_cpu, dq_cpu),
                          ("cuda", card.params, _to(dq_cpu, dev))):
        for name, draft in (("identical", (dict(tp), qconfig)), ("1-layer", (dp, dq))):
            out[where, name] = speculative_generate(tp, qconfig, draft[0], draft[1], ids,
                                                    max_tokens=32, stop_ids=set(), k=SPEC_K,
                                                    max_len=128)
    plain = list(card._tokens(ids, 32, 0.0, 1.0, 0, 0))  # the card's greedy, no draft
    for name in ("identical", "1-layer"):
        (tc, sc), (tg, sg) = out["cpu", name], out["cuda", name]
        print(f"  spec tiny qwen, {name} draft: card vs CPU "
              f"{sum(x == y for x, y in zip(tg, tc))}/{max(len(tg), len(tc))} tokens, card spec "
              f"vs card greedy {sum(x == y for x, y in zip(tg, plain))}/{max(len(tg), len(plain))};"
              f" accepted/proposed card {sg.accepted}/{sg.proposed}, CPU {sc.accepted}/"
              f"{sc.proposed}; target calls {sg.target_calls}, draft calls {sg.draft_calls}")
    gen = card.generate("hello there", max_tokens=16, temperature=0.0)
    assert gen.generation_tokens > 0


def _spec_print(label, wall, counts, peak, extra="") -> None:
    print(f"  {label}: wall {wall:.3f} s, {extra}launches {counts}, peak memory {peak:.2f} GiB")


def _spec_whisper_full() -> dict:
    """large-v3 (bf16 from seed 0, int4 cross, int8 self, sample_len
    SPEC_WHISPER_TOKENS, no timestamps) on one 30 s window of seeded noise:
    plain greedy, then spec_decode_task at k = 4 with the target itself as the draft (the
    upper bracket) and with a random large-v3-turbo-shaped draft sharing the
    encoder (the lower bracket). -> launches of the speculative runs."""
    from whisper_mlx_tpu_torch.decoding import greedy as greedy_mod
    from whisper_mlx_tpu_torch.decoding import speculative as spec_mod
    from whisper_mlx_tpu_torch.decoding.filters import apply_filters

    dev = torch.device("cuda")
    base, turbo = WHISPER_CONFIGS["large-v3"], WHISPER_CONFIGS["large-v3-turbo"]
    params, config = apply_asr_serving_config(
        init_params(base, seed=0, device=dev, dtype=torch.bfloat16), base, dev)
    turbo_full = init_params(turbo, seed=1, device=dev, dtype=torch.bfloat16)
    draft, dconfig = apply_asr_serving_config({"decoder": turbo_full.pop("decoder")}, turbo, dev)
    del turbo_full
    gc.collect()
    torch.cuda.empty_cache()
    tok = _bench_tokenizer(config.n_vocab)
    audio = torch.from_numpy(np.random.default_rng(7).standard_normal(N_SAMPLES)
                             .astype(np.float32) * 0.1).to(dev)
    opts = DecodingOptions(sample_len=SPEC_WHISPER_TOKENS, without_timestamps=True)
    setup = decode_setup(tok, opts, config, dev)
    n_init = len(setup.init_tokens)

    def mel():
        return log_mel_spectrogram(audio, config.n_mels)[None]

    with torch.inference_mode():  # warm-up: cuBLAS handles, the allocator
        short = dataclasses.replace(opts, sample_len=8)
        decode(params, mel(), tok, config, short)
        spec_mod.spec_decode_task(params, draft, mel(), tok, config, dconfig, short, k=SPEC_K)

    with _StepSpy(greedy_mod, params) as gspy:
        (plain,), wall, counts, peak = _spec_run(lambda: decode(params, mel(), tok, config, opts))
    _spec_print("spec large-v3 plain greedy", wall, counts, peak,
                f"{len(plain.tokens)} tokens, {len(gspy.calls)} decoder calls, ")
    assert len(plain.tokens) > 0
    step = [gspy.calls[0][3][0, -1]] + [c[3][0, -1] for c in gspy.calls[1:]]
    plain_buf = torch.zeros((1, config.n_text_ctx), dtype=torch.long, device=dev)
    seq = setup.init_tokens + plain.tokens
    plain_buf[0, :len(seq)] = torch.tensor(seq, device=dev)

    def filtered(row, buf, j):  # a position's filtered logits, its prefix in ``buf``
        return apply_filters(row.float()[None], buf, n_init + j, setup.suppress_mask,
                             setup.blank_mask, setup.filter_cfg)[0]

    with torch.inference_mode():  # D: teacher-forced verify blocks over the plain tokens
        xkv = cross_kv(params, encode(params, mel(), config), config)
        cache = init_kv_cache(config, 1, dev,
                              max_len=n_init + SPEC_WHISPER_TOKENS + SPEC_K + 1)
        decode_step(params, torch.tensor([setup.init_tokens], device=dev), 0, cache, xkv, config)
        full = torch.tensor([seq], device=dev)
        d = _verify_vs_step(step[:len(plain.tokens)], lambda s: decode_step(
            params, full[:, n_init + s:n_init + s + SPEC_K + 1], n_init + s, cache, xkv,
            config)[0][0])
        del xkv, cache

    launches = {}
    # the self-draft is a shallow copy, told apart from the target by the spy,
    # and given the target's encoder states, as the turbo-shaped one takes them
    for label, dp, dc in (("self-draft (upper bracket)", dict(params), config),
                          ("large-v3-turbo-shaped draft (lower bracket)", draft, dconfig)):
        with _StepSpy(spec_mod, params) as sspy:
            (res,), wall, counts, peak = _spec_run(lambda: spec_mod.spec_decode_task(
                params, dp, mel(), tok, config, dc, opts, k=SPEC_K, draft_shares_encoder=True))
        st = res.spec_stats
        committed = len(res.tokens) + (len(res.tokens) < SPEC_WHISPER_TOKENS)
        _spec_print(f"spec large-v3 {label}, k {SPEC_K}", wall, counts, peak,
                    f"{committed} committed tokens, proposed {st['proposed']}, accepted "
                    f"{st['accepted']} ({st['accepted'] / max(st['proposed'], 1):.3f}), target "
                    f"calls {st['target_calls']} (+1 prefill), draft calls "
                    f"{sspy.draft_calls()} (prefill included), ")
        for key, n in counts.items():
            launches[key] = launches.get(key, 0) + n
        got_buf = torch.zeros((1, config.n_text_ctx + SPEC_K + 1), dtype=torch.long, device=dev)
        got_seq = setup.init_tokens + res.tokens
        got_buf[0, :len(got_seq)] = torch.tensor(got_seq, device=dev)
        eot = tok.eot

        def tok_at(toks, j):
            return toks[j] if j < len(toks) else eot

        def gap_at(j):
            f = filtered(step[j], plain_buf, j)
            a, b = tok_at(plain.tokens, j), tok_at(res.tokens, j)
            assert torch.isfinite(f[a]) and torch.isfinite(f[b]), (a, b)
            return (f[a] - f[b]).item()

        def verify_gap(row, j, a, b):
            f = filtered(row, got_buf, j)
            return (f[a] - f[b]).item()

        # the verify holds [last, p1 .. pk] at s_len - 1: proposal i stands for
        # token pos + i - n_init
        rejections = (_rejections(sspy.calls, res.tokens, lambda pos, i: pos + i - n_init,
                                  verify_gap) if dc is config else None)
        _spec_check(f"large-v3 {label}", plain.tokens, res.tokens, gap_at, d, rejections)
    return launches


def _spec_llm_full() -> dict:
    """Qwen3-32B packed int4 (phase 9's weights, built again the same way)
    with two drafts, itself and a Qwen2.5-0.5B-shaped packed int4 draft from
    seed 1: LLMEngine(draft=...).generate for 32 new tokens at T = 0 beside
    the engine without a draft. -> launches of the speculative runs."""
    from whisper_mlx_tpu_torch.inference import generate as generate_mod
    from whisper_mlx_tpu_torch.inference import speculative as lspec_mod

    dev = torch.device("cuda")
    config = dataclasses.replace(QWEN32, dtype=torch.bfloat16, flash_attention=True)
    dconfig = dataclasses.replace(qw.QWEN_CONFIGS["qwen2.5-0.5b"], dtype=torch.bfloat16,
                                  flash_attention=True)
    t0 = time.perf_counter()
    params = qw.init_random_quant_params(config, seed=0, device=dev)
    dparams = qw.init_random_quant_params(dconfig, seed=1, device=dev)
    torch.cuda.synchronize()
    print(f"  spec llm: Qwen3-32B and a Qwen2.5-0.5B-shaped draft (int4) built in "
          f"{time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    tok = ByteFallbackTokenizer()
    prompt = _prompt_text(np.random.default_rng(6), 270)
    ids = tok.encode(prompt)
    new = 32  # short for the whole run's time limit
    plain_eng = LLMEngine(params, config, tok, max_context=4096)
    plain_eng.generate("warm up", max_tokens=4, temperature=0.0)
    with _StepSpy(generate_mod, params) as gspy:
        plain, wall, counts, peak = _spec_run(
            lambda: plain_eng.generate(prompt, max_tokens=new, temperature=0.0))
    _spec_print("spec Qwen3-32B plain greedy", wall, counts, peak,
                f"{plain.generation_tokens} tokens, ")
    assert plain.generation_tokens == new, plain.generation_tokens
    step = [gspy.calls[0][3][0, len(ids) - 1]] + [c[3][0, -1] for c in gspy.calls[1:]]
    with torch.inference_mode():  # D: teacher-forced verify blocks over the plain tokens
        cache = qw.init_kv_cache(config, 1, 4096, dev)
        qw.decode_step(params, torch.tensor([ids], device=dev), 0, cache, config)
        full = torch.tensor([ids + plain.tokens], device=dev)
        n0 = len(ids)
        d = _verify_vs_step(step[:new], lambda s: qw.decode_step(
            params, full[:, n0 + s:n0 + s + SPEC_K + 1], n0 + s, cache, config)[0][0])
        del cache

    launches = {}
    real_generate = lspec_mod.speculative_generate
    for label, draft in (("self-draft (upper bracket)", (dict(params), dataclasses.replace(config))),
                         ("Qwen2.5-0.5B-shaped draft (lower bracket)", (dparams, dconfig))):
        eng = LLMEngine(params, config, tok, max_context=4096, draft=draft)
        stats = []
        lspec_mod.speculative_generate = lambda *a, **kw: stats.append(
            real_generate(*a, **kw)) or stats[-1]
        try:
            with _StepSpy(lspec_mod, params) as sspy:
                res, wall, counts, peak = _spec_run(
                    lambda: eng.generate(prompt, max_tokens=new, temperature=0.0))
        finally:
            lspec_mod.speculative_generate = real_generate
        st = stats[0][1]
        _spec_print(f"spec Qwen3-32B {label}, k {SPEC_K}", wall, counts, peak,
                    f"{res.generation_tokens} committed tokens, proposed {st.proposed}, accepted "
                    f"{st.accepted} ({st.acceptance_rate:.3f}), target calls {st.target_calls} "
                    f"(prefill included), draft calls {st.draft_calls}, ")
        for key, n in counts.items():
            launches[key] = launches.get(key, 0) + n

        def gap_at(j):
            row = step[j].float()
            return (row[plain.tokens[j]] - row[res.tokens[j]]).item()

        rejections = (_rejections(sspy.calls, res.tokens, lambda pos, i: pos + i - n0,
                                  lambda row, j, a, b: (row[a] - row[b]).item())
                      if draft[0] is not dparams else None)
        _spec_check(f"Qwen3-32B {label}", plain.tokens, res.tokens, gap_at, d, rejections)
        del eng
    return launches, params


def _spec_kernel_times(params) -> dict:
    """K3 at the verify's shape (one window, Tq = 5, pos 226: self int8 of
    256 positions + cross int4) beside its 1-row reading, and K5 over
    Qwen3-32B's five linears at M = 5 beside M = 1, L2 cold, each with its
    bound; K5 at M = 5 against its plain version."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(8)
    self_c, cross_c = _quant_cache(rng, 1, 20, 256, 8), _quant_cache(rng, 1, 20, 1500, 4)
    out = {}
    for rows_q in (1, 5):
        q = torch.from_numpy(rng.standard_normal((1, 20, rows_q, 64)).astype(np.float32) * 0.35
                             ).to(dev, torch.bfloat16)
        ms = 0.0
        for c0, kw in ((self_c, dict(pos=226, causal=True)), (cross_c, dict(valid_len=1500))):
            layers = _layer_copies(lambda: tuple(t.clone() for t in c0), _nbytes(*c0))
            ms += _cold_ms(lambda c: da.decode_attention(q, *c, **kw), layers)
            del layers
        live = [(226 + rows_q, 64 + 64 + 2 + 2), (1500, 32 + 32 + 2 + 2)]
        bound = _bound(sum(20 * t * b for t, b in live) + 4 * _nbytes(q),
                       sum(20 * t * rows_q * 2 * 2 * 64 for t, _ in live), "fp32")
        out[f"k3_tq{rows_q}"] = (ms, bound)
        print(f"  spec K3 one window, Tq={rows_q}, self pos 226 + cross, L2 cold: {ms:.4f} ms, "
              f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})")
    gen = torch.Generator(device=dev).manual_seed(9)
    leaves = [("qkv", params["layers"][0]["attn"]["qkv"]["w"]),
              ("o", params["layers"][0]["attn"]["o"]["w"]),
              ("gate_up", params["layers"][0]["mlp"]["gate_up"]["w"]),
              ("down", params["layers"][0]["mlp"]["down"]["w"]),
              ("lm_head", params["lm_head"]["w"])]
    for m in (1, 5):
        ms = nbytes = ops = 0
        for name, q in leaves:
            n, k = q.shape
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            if m == 5:
                ref = qm.quant_matmul_plain(x, q.w_q, q.scales, q.biases, q.bits, q.group_size)
                _check(f"spec quant_matmul {name} N={n} K={k} M=5", tq.quant_matmul(x, q), ref,
                       QMM_TOL * max(1.0, ref.float().abs().max().item()))
                del ref
            size = _nbytes(q.w_q, q.scales, q.biases)
            copies = _layer_copies(lambda: dataclasses.replace(
                q, w_q=q.w_q.clone(), scales=q.scales.clone(), biases=q.biases.clone()), size)
            ms += _cold_ms(lambda c: tq.quant_matmul(x, c), copies)
            nbytes += size + _nbytes(x) + 2 * m * n
            ops += 2 * m * n * k
            del copies
            torch.cuda.empty_cache()
        bound = _bound(nbytes, ops, "bf16")
        out[f"k5_m{m}"] = (ms, bound)
        print(f"  spec K5 Qwen3-32B qkv + o + gate_up + down + lm_head at M={m}, L2 cold: "
              f"{ms:.4f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})")
    return out


def phase_spec() -> dict:
    """Phase 23: speculative decoding (ROADMAP M11): the tiny config card vs
    CPU, large-v3 and Qwen3-32B at full width, each between its two drafts'
    brackets, then K3 and K5 at the verify's shapes. -> the speculative
    runs' launches and the kernel times, for the JSON line."""
    _spec_tiny()
    gc.collect()
    torch.cuda.empty_cache()
    launches = _spec_whisper_full()
    gc.collect()
    torch.cuda.empty_cache()
    llm_launches, params = _spec_llm_full()
    launches.update({k: v for k, v in llm_launches.items()
                     if k in ("flash", "quant", "quant_tiled")})
    times = _spec_kernel_times(params)
    _QWEN32_PARAMS["params"] = params  # phase 24 serves these weights
    del params
    print(f"spec: {_smi()}; launches over the speculative runs {launches}")
    for key, n in launches.items():
        assert n > 0, f"kernel {key} was not launched on the speculative path"
    return {"launches": launches, "times": times}



# ---------------------------------------------------------------------------
# the HTTP daemon (ROADMAP M13): /v1/transcribe on K1-K3, /v1/chat on K4-K5
# ---------------------------------------------------------------------------

# Qwen3-32B's packed weights of phase 23, kept for phases 24 and 25 (which
# build them again the same way when run alone)
_QWEN32_PARAMS: dict = {}
# the served batcher's flush (deadline, idle gap in ms) for phase 24's
# checked burst: raised from the serving defaults (50/25) so that the four
# HTTP arrivals ride one batch whatever the host's timing; the same burst
# then runs again at the defaults, where its batches are a measurement
CHECKED_FLUSH = (3000.0, 1000.0)


def _http(base: str, method: str, path: str, body=None, multipart: str | None = None,
          timeout: float = 600.0):
    """One request over real HTTP -> (seconds, status, JSON or SSE events).
    A status other than 2xx raises (urllib's HTTPError)."""
    import urllib.request

    headers, data = {}, None
    if multipart is not None:  # the file as a multipart upload
        boundary = "chipsmoke" + hashlib.sha1(multipart.encode()).hexdigest()[:16]
        with open(multipart, "rb") as f:
            data = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
                    f"filename=\"{os.path.basename(multipart)}\"\r\nContent-Type: audio/wav"
                    f"\r\n\r\n").encode() + f.read() + f"\r\n--{boundary}--\r\n".encode()
        headers["Content-Type"] = f"multipart/form-data; boundary={boundary}"
    elif body is not None:
        data = json.dumps(body).encode()
        headers["Content-Type"] = "application/json"
    req = urllib.request.Request(base + path, data=data, headers=headers, method=method)
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if resp.headers.get("Content-Type", "").startswith("text/event-stream"):
            out = [json.loads(line[6:]) for line in (raw.decode().strip() for raw in resp)
                   if line.startswith("data: ")]
        else:
            out = json.loads(resp.read())
        return time.perf_counter() - t0, resp.status, out


class _WordyLLMTokenizer(ByteFallbackTokenizer):
    """The byte tokenizer, with every id past its own vocabulary decoded to
    a four-letter word: random Qwen3-32B weights sample ids of all 151,936,
    which the byte tokenizer decodes to nothing, so that a reply streams no
    text."""

    def decode(self, ids):
        out, run = [], []
        for t in list(ids) + [None]:
            if t is not None and t < self.vocab_size:
                run.append(t)
                continue
            out.append(super().decode(run))  # bytes and specials as they are
            run = []
            if t is not None:
                i = t - self.vocab_size
                out.append(" " + "".join(chr(97 + (i // 26 ** k) % 26) for k in range(4)))
        return "".join(out)


def _concurrently(*calls):
    """Each call in a thread of its own, all started at once -> results."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(calls)) as pool:
        futures = [pool.submit(c) for c in calls]
        return [f.result() for f in futures]


def _daemon_counts() -> dict:
    return {"mel": mk.LAUNCHES, "dense": dn.LAUNCHES, "decode": da.LAUNCHES,
            "flash": fa.LAUNCHES, "quant": qm.LAUNCHES}


def phase_daemon() -> dict:
    """Phase 24: the port's HTTP daemon (ROADMAP M13) at full width.
    ``serving.server.create_app(whisper_model="large-v3", device="cuda")``
    (random weights of seed 0 built on the card, the serving config: bf16,
    flash, int4 cross and int8 self caches) behind aiohttp's AppRunner and a
    TCPSite on 127.0.0.1 at a free port, its event loop in a thread; every
    request from this thread over real HTTP with urllib. The chat model is
    Qwen3-32B packed int4 with random weights: phase 23's weights (built
    again when the phase runs alone) in an LLMEngine handed to
    ``QwenModel.get(LARGE, None, "cuda")`` before the first chat, since
    writing an 18 GB checkpoint only to read it back would cost the
    script's time. The served whisper model gets phase 22's four-letter-word
    tokenizer (the real special-token layout; ``load_model`` gives a size
    the synthetic byte one), so that random tokens make words. The general
    profile's system and tool prompt (10,689 bytes) is longer than the
    engine's context, which keeps its last 4,032 tokens.
    Requests: /health; a burst of four /v1/transcribe (65, 30, 20, 65 s; two
    uploads, two paths) with the served batcher's flush raised to
    CHECKED_FLUSH, one 8-window batch whose tokens must equal a
    TranscriptionBatcher's called directly on the same params and audios
    in the arrival order the served batcher saw; the same burst at the
    serving knobs' default flush, its batches counted and its tokens set
    beside the checked burst's; /v1/transcribe/stream; /v1/transcribe with options
    (the sequential transcribe with words); /v1/chat; a session and its SSE
    chat; two chats at once on one slot (exactly one queued); a tool
    invocation. K1-K5's launches over the HTTP requests must each be above
    0. -> those launches."""
    import asyncio
    import socket
    import threading

    from aiohttp import web

    from whisper_mlx_tpu_torch.inference.generate import apply_chat_template
    from whisper_mlx_tpu_torch.serving import server as server_mod
    from whisper_mlx_tpu_torch.serving.chat import ChatService, ModelSize, QwenModel
    from whisper_mlx_tpu_torch.serving.profiles import get_profile
    from whisper_mlx_tpu_torch.serving.sessions import SessionStore, set_session_store
    from whisper_mlx_tpu_torch.serving.sync import auth, storage
    from whisper_mlx_tpu_torch.serving.tools.mirror import data_store

    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_daemon_")
    # the daemon's stores under the phase's own directory, not $HOME
    set_session_store(SessionStore(os.path.join(tmp, "sessions")))
    saved = (storage.DATA_DIR, data_store.MIRROR_DATA_DIR, auth.ACCOUNTS_DIR)
    storage.DATA_DIR = auth.ACCOUNTS_DIR = pathlib.Path(tmp) / "data"
    data_store.MIRROR_DATA_DIR = os.path.join(tmp, "mirror")

    torch.cuda.reset_peak_memory_stats()
    config = dataclasses.replace(QWEN32, dtype=torch.bfloat16, flash_attention=True)
    params = _QWEN32_PARAMS.get("params")  # kept for phase 25
    if params is None:
        params = qw.init_random_quant_params(config, seed=0, device=dev)
    llm_tok = _WordyLLMTokenizer()
    qwen = QwenModel.get(ModelSize.LARGE, None, "cuda")
    qwen._engine = LLMEngine(params, config, llm_tok, max_context=4096)
    del params
    # the prompt of a general-profile chat, as the service builds it
    messages = ChatService(qwen)._build_messages(get_profile("general"), [], "hello")
    prompt_tokens = len(llm_tok.encode(apply_chat_template(messages)))

    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, name="daemon-loop", daemon=True)
    thread.start()

    def on_loop(coro, timeout=600):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)

    seconds = (65.0, 30.0, 20.0, 65.0)  # 3 + 1 + 1 + 3 windows
    runner = None
    try:
        t0 = time.perf_counter()
        app = server_mod.create_app(whisper_model="large-v3", device="cuda")
        runner = web.AppRunner(app)
        real_load = cli.load_model

        def load_with_words(name, model_dir, device):
            params, config, _ = real_load(name, model_dir, device)
            return params, config, _wordy_tokenizer(config.n_vocab)

        cli.load_model = load_with_words
        try:
            on_loop(runner.setup())  # on_startup: large-v3 on the card, the batcher
        finally:
            cli.load_model = real_load
        asr_params, asr_config, wordy = app["asr"]
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        on_loop(web.TCPSite(runner, "127.0.0.1", port).start())
        base = f"http://127.0.0.1:{port}"
        print(f"daemon: create_app(whisper_model='large-v3', device='cuda') up on port {port} in "
              f"{time.perf_counter() - t0:.2f} s (batcher buckets {app['batcher'].buckets}, "
              f"flush {app['batcher'].max_wait_ms:g}/{app['batcher'].idle_gap_ms:g} ms); chat "
              f"model Qwen3-32B packed int4; the general profile's prompt {prompt_tokens} "
              f"tokens, cut to the engine's last {4096 - 64}")
        wavs = []
        for i, sec in enumerate(seconds):
            wavs.append(os.path.join(tmp, f"req{i}.wav"))
            _wav_file(wavs[-1], _request_audio(sec, i))

        torch.cuda.synchronize()
        mk.LAUNCHES = dn.LAUNCHES = da.LAUNCHES = fa.LAUNCHES = qm.LAUNCHES = 0
        wall, status, health = _http(base, "GET", "/health")
        assert health["tools_count"] == 24 and len(health["profiles"]) == 3, health
        print(f"  GET /health: {status}, {health['tools_count']} tools, profiles "
              f"{health['profiles']}, wall {wall * 1e3:.1f} ms")

        audios = [load_audio_serving(w) for w in wavs]  # int16, as the server reads them
        served = app["batcher"]
        served.decoding = dataclasses.replace(served.decoding, sample_len=BATCH_SAMPLE_LEN)
        default_flush = (served.max_wait_ms, served.idle_gap_ms)
        arrivals = []  # a burst's requests in the order the served batcher took them
        real_enqueue = served._enqueue

        async def enqueue(audio):
            arrivals.append(next((i for i, a in enumerate(audios)
                                  if a.shape == audio.shape and np.array_equal(a, audio)), -1))
            return await real_enqueue(audio)

        served._enqueue = enqueue

        def http_burst(flush):
            """The four requests at once over HTTP, two uploads and two
            paths, the served batcher's flush set to ``flush`` -> (wall,
            results, the batcher's stats over the burst, arrival order)."""
            served.max_wait_ms, served.idle_gap_ms = flush
            before = dict(served.stats)
            del arrivals[:]
            t0 = time.perf_counter()
            burst = _concurrently(
                lambda: _http(base, "POST", "/v1/transcribe", multipart=wavs[0]),
                lambda: _http(base, "POST", "/v1/transcribe", {"path": wavs[1]}),
                lambda: _http(base, "POST", "/v1/transcribe", multipart=wavs[2]),
                lambda: _http(base, "POST", "/v1/transcribe", {"path": wavs[3]}))
            wall = time.perf_counter() - t0
            results = [r[2] for r in burst]
            _check_segments(results, seconds)
            stats = {k: v - before.get(k, 0) for k, v in served.stats.items()}
            assert stats["windows"] == 8 and sorted(arrivals) == [0, 1, 2, 3], (stats, arrivals)
            print(f"  burst: 4 x POST /v1/transcribe ({', '.join(f'{s:.0f}' for s in seconds)} "
                  f"s; two uploads, two paths) at once, flush {flush[0]:g}/{flush[1]:g} ms: "
                  f"{stats['batches']} batches, fill {stats['fill_sum'] / stats['batches']:.3f}, "
                  f"wall {wall:.3f} s ({sum(seconds) / wall:.2f} audio-s/s), latency_ms "
                  f"{[round(r['latency_ms'], 1) for r in results]}, arrival order {arrivals}")
            return wall, results, stats, list(arrivals)

        # the checked burst: one 8-window batch, its wall holding up to the
        # raised idle gap (1 s) after the last arrival
        _, results, stats, order = http_burst(CHECKED_FLUSH)
        assert stats["batches"] == 1, stats
        # the same burst at the serving defaults, as a daemon started with no
        # flush knobs takes it: its batches are what HTTP arrivals give
        _, results_default, stats_default, _ = http_burst(default_flush)
        same_default = sum([s["tokens"] for s in a["segments"]] == [s["tokens"] for s in b["segments"]]
                           for a, b in zip(results_default, results))
        print(f"  at the default flush: {stats_default['batches']} batches; requests whose tokens "
              f"equal the checked burst's: {same_default} of 4")

        wall, _, events = _http(base, "POST", "/v1/transcribe/stream", {"path": wavs[0]})
        kinds = [e["event"] for e in events]
        assert kinds == ["window"] * 3 + ["complete"], kinds
        assert [e["window"] for e in events[:3]] == [0, 1, 2], events
        print(f"  POST /v1/transcribe/stream (65 s): events {kinds}, wall {wall:.3f} s")

        wall, _, out = _http(base, "POST", "/v1/transcribe", {"path": wavs[1], "options": {
            "word_timestamps": True, "temperature": 0.0}})
        # the sequential seek advances to each window's last timestamp, so
        # a window may start before the audio's end and run 30 s past it
        words = _check_segments([out], (seconds[1] + 30.0,))
        assert words > 0, "the sequential transcribe with words returned no word"
        print(f"  POST /v1/transcribe with options (30 s, words, T = 0; int16 converted to "
              f"f32, the sequential transcribe): language {out['language']!r} detected, "
              f"{len(out['segments'])} segments, {words} words, wall {wall:.3f} s, latency_ms "
              f"{out['latency_ms']:.1f}")

        wall, _, chat = _http(base, "POST", "/v1/chat", {"message": "hello", "max_tokens": 32})
        assert chat["rounds"] >= 1 and chat["response"], chat
        print(f"  POST /v1/chat (general, max_tokens 32): rounds {chat['rounds']}, "
              f"{len(chat['response'])} chars, wall {wall:.3f} s, latency_ms "
              f"{chat['latency_ms']:.1f}, queue {chat['queue_stats']}")

        _, status, session = _http(base, "POST", "/v1/sessions", {"profile": "general"})
        assert status == 201, status
        sid = session["id"]
        wall, _, events = _http(base, "POST", f"/v1/sessions/{sid}/chat/stream",
                                {"message": "hello"})
        kinds = [e["event"] for e in events]
        assert "token" in kinds and kinds[-1] == "complete", kinds
        _, _, full = _http(base, "GET", f"/v1/sessions/{sid}")
        assert [m["role"] for m in full["messages"]] == ["user", "assistant"], full
        print(f"  POST /v1/sessions, then /chat/stream: {kinds.count('token')} token events, "
              f"{kinds[0]} ... {kinds[-1]}, wall {wall:.3f} s; GET /v1/sessions/{{id}}: "
              f"{len(full['messages'])} messages")

        body = {"message": "hello", "max_tokens": 8}
        t0 = time.perf_counter()
        pair = _concurrently(lambda: _http(base, "POST", "/v1/chat", body),
                             lambda: _http(base, "POST", "/v1/chat", body))
        pair_wall = time.perf_counter() - t0
        queued = sorted((r[2]["queue_stats"]["was_queued"], r[2]["queue_stats"]["queue_position"])
                        for r in pair)
        assert queued == [(False, 0), (True, 1)], queued
        _, _, status_body = _http(base, "GET", "/v1/generation/status")
        assert status_body == {"active": None, "queued": [], "queue_length": 0}, status_body
        print(f"  2 x POST /v1/chat at once on one slot: queue_stats "
              f"{[r[2]['queue_stats'] for r in pair]}, wall {pair_wall:.3f} s; then "
              f"/v1/generation/status {status_body}")

        wall, _, tool = _http(base, "POST", "/v1/tools/get_current_datetime/invoke",
                              {"arguments": {}})
        assert "utc" in tool["result"], tool
        torch.cuda.synchronize()
        launches = _daemon_counts()
        print(f"  POST /v1/tools/get_current_datetime/invoke: wall {wall * 1e3:.1f} ms")
        print(f"  launches over the HTTP requests {launches}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        for key, n in launches.items():
            assert n > 0, f"kernel {key} was not launched behind the daemon"

        # the checked burst's tokens against the batcher called directly:
        # the same params and audios submitted in the HTTP arrival order, so
        # the same 8-window batch, row for row (after the request with
        # options, whose language detection must leave the served tokenizer
        # as it was: F7)
        direct = TranscriptionBatcher(asr_params, asr_config, wordy, device=dev,
                                      decoding=served.decoding)
        in_order, _ = _burst(direct, [audios[i] for i in order])
        ref = [in_order[order.index(i)] for i in range(len(audios))]
        assert direct.stats["batches"] == 1 and direct.stats["windows"] == 8, direct.stats
        for i, (got, want) in enumerate(zip(results, ref)):
            got_t = [s["tokens"] for s in got["segments"]]
            assert got_t == [s["tokens"] for s in want["segments"]], \
                f"request {i}: tokens over HTTP differ from the direct batcher's"
        print(f"  burst tokens over HTTP equal the direct TranscriptionBatcher's in arrival "
              f"order {order} ({sum(len(s['tokens']) for r in results for s in r['segments'])} "
              f"tokens)")
    finally:
        if runner is not None:
            batcher = runner.app.get("batcher")
            if batcher is not None:
                loop.call_soon_threadsafe(batcher.shutdown)
            on_loop(runner.cleanup())
        on_loop(loop.shutdown_default_executor())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)
        loop.close()
        QwenModel._instances.clear()
        set_session_store(None)
        storage.DATA_DIR, data_store.MIRROR_DATA_DIR, auth.ACCOUNTS_DIR = saved
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"daemon: {_smi()}")
    return {f"{k}_daemon": v for k, v in launches.items()}

# ---------------------------------------------------------------------------
# the quantized LLM KV cache (ROADMAP M12, route R2): K3's GQA mode
# ---------------------------------------------------------------------------

# a tiny Qwen3-shaped model whose attention the GQA mode takes on the card
# (hd 128, 4 KV heads at rep 2)
TINY_KV = dict(vocab_size=512, hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
               num_attention_heads=8, num_key_value_heads=4, head_dim=128, qk_norm=True,
               attention_bias=False, tie_word_embeddings=False)


class _Env:
    """Environment variables (``WTPU_LLM_KV_BITS``, ``QWEN_BATCH_SLOTS``)
    set while in use, as a user sets them before building the engine."""

    def __init__(self, **env):
        self.env = {k: str(v) for k, v in env.items()}

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _kv_counts() -> dict:
    return {"gqa": gq.LAUNCHES, "flash": fa.LAUNCHES, "quant": qm.LAUNCHES,
            "quant_tiled": qm.TILED_LAUNCHES}


def _zero_kv_counts() -> None:
    gq.LAUNCHES = fa.LAUNCHES = qm.LAUNCHES = qm.TILED_LAUNCHES = 0


def _llm_kv_tiny() -> None:
    """The tiny config card vs CPU at kv 8 and 4, both engines in the bf16
    flash configuration: prefill and step logits within TINY_LOGIT_TOL, and
    the greedy tokens of LLMEngine under WTPU_LLM_KV_BITS."""
    config = serving_config(qw.QwenConfig(**TINY_KV), torch.device("cuda"))
    params_cpu = _to(qw.init_params(config, seed=0), torch.bfloat16)
    params_dev = _to(params_cpu, "cuda")
    prompt = np.random.default_rng(11).integers(0, 263, size=(2, 40))
    text = "<|im_start|>user\nsay something<|im_end|>\n<|im_start|>assistant\n"
    for bits in (8, 4):
        cfg = dataclasses.replace(config, kv_bits=bits)
        logits = {}
        for label, params, dev in (("cpu", params_cpu, "cpu"), ("cuda", params_dev, "cuda")):
            cache = qw.init_kv_cache(cfg, 2, 64, dev)
            toks = torch.from_numpy(prompt).to(dev)
            pre, cache = qw.decode_step(params, toks, 0, cache, cfg)
            step, cache = qw.decode_step(params, toks[:, :1], [40, 40], cache, cfg)
            block, cache = qw.decode_step(params, toks[:, 1:6], 41, cache, cfg)
            logits[label] = [x.float().cpu() for x in (pre, step, block)]
        for name, got, ref in zip(("prefill", "per-row step", "5-token block"), logits["cuda"],
                                  logits["cpu"]):
            assert torch.isfinite(got).all(), f"non-finite tiny qwen kv{bits} {name} logits"
            _check(f"tiny qwen kv{bits} {name} logits cuda vs cpu", got, ref,
                   TINY_LOGIT_TOL * max(1.0, ref.abs().max().item()))
        with _Env(WTPU_LLM_KV_BITS=bits):
            cpu = LLMEngine(params_cpu, config, ByteFallbackTokenizer(), max_context=256)
            card = LLMEngine(params_dev, config, ByteFallbackTokenizer(), max_context=256)
        assert cpu.config.kv_bits == card.config.kv_bits == bits
        before = gq.LAUNCHES
        a = cpu.generate(text, max_tokens=32, temperature=0.0).tokens
        b = card.generate(text, max_tokens=32, temperature=0.0).tokens
        assert gq.LAUNCHES > before, "K3's GQA mode was not launched by the tiny engine"
        same = sum(x == y for x, y in zip(a, b))
        print(f"  tiny qwen kv{bits} greedy tokens: cpu {len(a)}, cuda {len(b)}, agreement "
              f"{same}/{max(len(a), len(b))}, first difference at {_first_difference(a, b)}")


def _engine_logits(params, config, ids: list, tokens: list) -> torch.Tensor:
    """The logits of LLMEngine's greedy loop fed ``tokens``: the prefill of
    the bucketed prompt, then a step a token, at the engine's positions ->
    (len(tokens), V) fp32 rows, row j the logits that chose token j."""
    dev = torch.device("cuda")
    bucket = -(-len(ids) // LLMEngine.PROMPT_BUCKET) * LLMEngine.PROMPT_BUCKET
    cache = qw.init_kv_cache(config, 1, 4096, dev)
    logits, _ = qw.decode_step(params, torch.tensor([ids + [0] * (bucket - len(ids))],
                                                    device=dev), 0, cache, config)
    rows = [logits[0, len(ids) - 1].float()]
    for i, t in enumerate(tokens[:-1]):
        logits, _ = qw.decode_step(params, torch.tensor([[t]], device=dev), len(ids) + i,
                                   cache, config)
        rows.append(logits[0, -1].float())
    return torch.stack(rows)


class _PlainGQA:
    """models/qwen.py's attention over a quantized cache through the GQA
    mode's plain version, on the card, while in use: a comparison run's."""

    def __enter__(self):
        self.real = qw.gqa_decode_attention
        qw.gqa_decode_attention = gq.gqa_decode_attention_plain
        return self

    def __exit__(self, *exc):
        qw.gqa_decode_attention = self.real


def _fill_cache(cache, gen) -> int:
    """Random codes, scales or values in every key of a cache, as a long
    context leaves it -> its bytes."""
    total = 0
    for layer in cache:
        for key, t in layer.items():
            if t.dtype == torch.int8:
                t.random_(-127, 128, generator=gen)
            elif t.dtype == torch.uint8:
                t.random_(0, 256, generator=gen)
            elif key in ("ks", "vs"):
                t.uniform_(0.005, 0.03, generator=gen)
            else:
                t.normal_(generator=gen)
            total += _nbytes(t)
    return total


def _kv_step_times(params, config) -> None:
    """Device ms a decode step at B = 1 and on 4 slots at a live length of
    about 3,500 (caches filled with random entries) for kv 0, 8 and 4, from
    the profiler's device events; each cache's GiB at max_context 4096."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    for bits in (0, 8, 4):
        cfg = dataclasses.replace(config, kv_bits=bits)
        for rows in (1, 4):
            cache = qw.init_kv_cache(cfg, rows, 4096, dev)
            nbytes = _fill_cache(cache, gen)
            tok1 = torch.zeros((rows, 1), dtype=torch.long, device=dev)
            pos = [3500] if rows == 1 else [3400, 3450, 3500, 3550]

            def steps(n):
                for i in range(n):
                    qw.decode_step(params, tok1, pos[0] + i if rows == 1 else
                                   [x + i for x in pos], cache, cfg)

            steps(1)
            _, ms = _sync_ms(lambda: steps(3))
            # the device's events only: with the host's operators too, the
            # profiler's summary of a 64-layer step takes seconds
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                _, prof_ms = _sync_ms(lambda: steps(2))
            device_us, top = _kernel_us(prof)
            attn = sum(e.self_device_time_total for e in top if "gqa" in e.key)
            print(f"  kv {bits} at {rows} row(s), live ~3,500: cache {nbytes / 2**30:.3f} GiB "
                  f"({nbytes / rows / 2**30:.3f} a slot of 4,096), wall {ms / 3:.3f} ms/step, "
                  + (f"device {device_us / 1e3 / 2:.3f} ms/step (K3 GQA {attn / 1e3 / 2:.3f}), "
                     f"idle share {1 - device_us / 1e3 / prof_ms:.3f}" if device_us
                     else "device not measured"))
            for e in top[:4]:
                print(f"    {e.key[:60]:60s} device {e.self_device_time_total / 2:9.1f} us/step, "
                      f"calls {e.count // 2}/step")
            del cache
            torch.cuda.empty_cache()


def _llm_kv_daemon(params, config) -> dict:
    """The daemon in process over real HTTP with QWEN_BATCH_SLOTS=4 and
    WTPU_LLM_KV_BITS=8 (chat only; phase 23's Qwen3-32B weights in an
    LLMEngine handed to QwenModel as phase 24 does): four overlapping
    /v1/chat requests on the continuous-batching engine over the quantized
    cache -> the launches of K3's GQA mode, K4 and K5 over them."""
    import asyncio
    import socket
    import threading

    from aiohttp import web

    from whisper_mlx_tpu_torch.serving import server as server_mod
    from whisper_mlx_tpu_torch.serving.chat import ModelSize, QwenModel
    from whisper_mlx_tpu_torch.serving.sessions import SessionStore, set_session_store
    from whisper_mlx_tpu_torch.serving.sync import auth, storage
    from whisper_mlx_tpu_torch.serving.tools.mirror import data_store

    tmp = tempfile.mkdtemp(prefix="chip_smoke_llm_kv_")
    # the daemon's stores under the phase's own directory, not $HOME
    set_session_store(SessionStore(os.path.join(tmp, "sessions")))
    saved = (storage.DATA_DIR, data_store.MIRROR_DATA_DIR, auth.ACCOUNTS_DIR)
    storage.DATA_DIR = auth.ACCOUNTS_DIR = pathlib.Path(tmp) / "data"
    data_store.MIRROR_DATA_DIR = os.path.join(tmp, "mirror")
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, name="llm-kv-loop", daemon=True)
    thread.start()

    def on_loop(coro, timeout=600):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)

    runner = None
    try:
        with _Env(QWEN_BATCH_SLOTS=4, WTPU_LLM_KV_BITS=8):
            app = server_mod.create_app(device="cuda")
            qwen = QwenModel.get(ModelSize.LARGE, None, "cuda")
            qwen._engine = LLMEngine(params, config, _WordyLLMTokenizer(), max_context=4096)
            assert qwen._engine.config.kv_bits == 8, qwen._engine.config
            runner = web.AppRunner(app)
            on_loop(runner.setup())
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
            on_loop(web.TCPSite(runner, "127.0.0.1", port).start())
            base = f"http://127.0.0.1:{port}"
            torch.cuda.synchronize()
            _zero_kv_counts()
            t0 = time.perf_counter()
            replies = _concurrently(*(
                lambda i=i: _http(base, "POST", "/v1/chat",
                                  {"message": f"question {i}", "max_tokens": 16,
                                   "temperature": 0.0}) for i in range(4)))
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            launched = _kv_counts()
        batch = qwen._engine._batch_engine
        assert batch is not None, "the chats did not reach the continuous-batching engine"
        for i, (w, status, body) in enumerate(replies):
            assert status == 200 and body["response"], (i, status, body)
        print(f"  daemon, QWEN_BATCH_SLOTS=4 WTPU_LLM_KV_BITS=8: 4 x POST /v1/chat at once "
              f"(general profile, max_tokens 16, T = 0) answered in "
              f"{[round(r[0], 3) for r in replies]} s, wall {wall:.3f} s; the batch engine's "
              f"steps {batch._steps}, max occupancy {max(batch._step_occupancy)}; launches "
              f"over them {launched}")
        assert launched["gqa"] > 0, "K3's GQA mode was not launched behind the daemon"
        batch.close()
        return launched
    finally:
        if runner is not None:
            on_loop(runner.cleanup())
        on_loop(loop.shutdown_default_executor())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)
        loop.close()
        QwenModel._instances.clear()
        set_session_store(None)
        storage.DATA_DIR, data_store.MIRROR_DATA_DIR, auth.ACCOUNTS_DIR = saved
        shutil.rmtree(tmp, ignore_errors=True)


def phase_llm_kv() -> dict:
    """Phase 25: the quantized LLM KV cache (ROADMAP M12, R2). The tiny
    config card vs CPU at kv 8 and 4; then Qwen3-32B packed int4 at full
    width, all 64 layers (phase 23's weights, built again when the phase
    runs alone): LLMEngine.generate, 32 tokens at T = 0, under
    WTPU_LLM_KV_BITS = 0, 8 and 4; the kv-8 engine again with the GQA
    mode's plain version on the card, whose tokens must equal the kernel's
    up to a first parting that is a near tie (the plain run's gap between
    the two tokens within SPEC_TIE_FACTOR times D, the largest logit
    difference between kernel and plain over the kernel run's tokens,
    teacher-forced, in this run); the continuous-batching engine, 4 slots
    and 6 requests, at kv 8; device ms a decode step at B = 1 and on 4
    slots at a live length of about 3,500 and the caches' GiB, for kv 0, 8
    and 4; the daemon with QWEN_BATCH_SLOTS=4 and WTPU_LLM_KV_BITS=8 under
    four overlapping chats. -> the launches of K3's GQA mode, K4 and K5
    over the engines' and the daemon's runs (the comparison runs left out)."""
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    _llm_kv_tiny()
    print(f"  (tiny: {time.perf_counter() - t_phase:.1f} s)")
    gc.collect()
    torch.cuda.empty_cache()
    config = dataclasses.replace(QWEN32, dtype=torch.bfloat16, flash_attention=True)
    params = _QWEN32_PARAMS.pop("params", None)
    if params is None:
        params = qw.init_random_quant_params(config, seed=0, device=dev)
    torch.cuda.reset_peak_memory_stats()
    t_section = time.perf_counter()

    def section(name):
        nonlocal t_section
        print(f"  ({name}: {time.perf_counter() - t_section:.1f} s)")
        t_section = time.perf_counter()

    tok = ByteFallbackTokenizer()
    prompt = _prompt_text(np.random.default_rng(6), 270)
    ids = tok.encode(prompt)
    new = 32
    totals = dict.fromkeys(_kv_counts(), 0)

    def counted(fn):
        _zero_kv_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _kv_counts()
        for key, n in counts.items():
            totals[key] += n
        return out, wall, counts

    engines, tokens = {}, {}
    for bits in (0, 8, 4):
        with _Env(WTPU_LLM_KV_BITS=bits):
            eng = LLMEngine(params, config, tok, max_context=4096)
        assert eng.config.kv_bits == bits, eng.config
        if not engines:
            eng.generate("warm up", max_tokens=4, temperature=0.0)
        res, wall, counts = counted(lambda: eng.generate(prompt, max_tokens=new,
                                                         temperature=0.0))
        assert res.generation_tokens == new, res.generation_tokens
        assert (counts["gqa"] > 0) == (bits > 0), counts
        engines[bits], tokens[bits] = eng, res.tokens
        print(f"  Qwen3-32B LLMEngine.generate, WTPU_LLM_KV_BITS={bits}: {len(ids)}-token "
              f"prompt, {new} tokens in {wall:.3f} s ({new / wall:.2f} tok/s), launches {counts}")
    for bits in (8, 4):
        same = sum(x == y for x, y in zip(tokens[0], tokens[bits]))
        print(f"  kv {bits} against the fp cache: {same}/{new} tokens agree, first difference "
              f"at {_first_difference(tokens[0], tokens[bits])} (the quantization's own effect)")
    section("engines")

    # the check: the kv-8 engine with the GQA mode's plain version on the card
    with _PlainGQA():
        plain = engines[8].generate(prompt, max_tokens=new, temperature=0.0).tokens
    first = _first_difference(tokens[8], plain)
    upto = new if first is None else first + 1  # D over the steps up to the parting
    with torch.inference_mode():
        kernel_rows = _engine_logits(params, engines[8].config, ids, tokens[8][:upto])
        with _PlainGQA():
            plain_rows = _engine_logits(params, engines[8].config, ids, tokens[8][:upto])
    d = (kernel_rows - plain_rows).abs().max().item()
    tol = SPEC_TIE_FACTOR * d
    same = sum(x == y for x, y in zip(tokens[8], plain))
    msg = (f"  kv 8, kernel against plain version on the card: {same}/{new} tokens agree, "
           f"first difference at {first}; largest logit difference D "
           f"{d:.4e}, near-tie limit {tol:.4e}")
    if first is not None:
        row = plain_rows[first]
        gap = (row[plain[first]] - row[tokens[8][first]]).item()
        msg += f"; the plain run's gap there {gap:.4e}"
        if not gap <= tol:
            raise AssertionError(f"kv 8: kernel and plain tokens part at {first} with a gap of "
                                 f"{gap} > {tol} (D {d})")
    print(msg)
    del kernel_rows, plain_rows
    section("kernel against plain version")

    batch = engines[8].continuous(4)
    rng = np.random.default_rng(7)
    prompts = [_prompt_text(rng, 100 + 40 * i) for i in range(6)]

    def run_batch():
        handles = [batch.submit(p, max_tokens=new, temperature=0.0) for p in prompts]
        return [len(list(h.tokens())) for h in handles]

    counts_b, wall, counts = counted(run_batch)
    assert batch.alive, "the batch engine's worker thread died"
    assert counts_b == [new] * 6, f"batch requests received {counts_b} tokens"
    assert counts["gqa"] > 0, counts
    print(f"  continuous batching at kv 8: 6 requests x {new} tokens on 4 slots in {wall:.3f} s "
          f"({6 * new / wall:.2f} tok/s, max occupancy {max(batch._step_occupancy)}), launches "
          f"{counts}")
    batch.close()
    del engines, batch
    gc.collect()
    section("continuous batching")

    _kv_step_times(params, config)
    section("decode steps")
    for key, n in _llm_kv_daemon(params, config).items():
        totals[key] += n
    section("daemon")
    del params
    print(f"  launches over the phase's engine and daemon runs: K3 GQA {totals['gqa']}, K4 "
          f"{totals['flash']}, K5 {totals['quant']} (the tiled core {totals['quant_tiled']}); "
          f"peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for key, n in totals.items():
        assert n > 0, f"kernel {key} was not launched on the quantized-cache path"
    print(f"llm_kv: {_smi()}")
    return {f"{k}_kv": v for k, v in totals.items()}


# --- phase 26: the reference's last opt-ins (ROADMAP M15) and F9 ---------

# K8's split mode timed at the large-v3 beam shape, one s_fill a window for
# every window of a case; the per-lane layout at one layer's per-lane cache
M15_FILLS = (0, 100, 200, 226)
M15_LANE_T = 256
M15_LEN = 64  # decode depth of the phase's large-v3 runs (2 windows): cut for the time limit
M15_WINDOWS = (64, 8)  # the shared scheme's read windows: roomy, and one the overflow takes
TRACE_EXTRA = 64  # candidates recorded past the beam's 2B, to find a parting's other one


def _split_ancestry(gen, s_fill: int, n: int = BEAM_N, g: int = BEAM_G, t_pos: int = BEAM_T):
    """A beam-built ancestry whose lanes agree below ``s_fill``, as the
    shared scheme's commits keep them."""
    anc = _beam_ancestry(gen, n, g, t_pos).reshape(n, g, t_pos)
    anc[:, :, :s_fill] = anc[:, :1, :s_fill]
    return anc.reshape(n * g, t_pos).contiguous()


def _run_ancestry(gen, n, g, t_pos, start: int, rejoin: bool = False):
    """One random history for all lanes of a window but at ``start`` and on
    (rejoin: at start, start + 1 and start + 2 only), where every lane's row
    is its own: K8's agreed run is ``start`` positions long."""
    anc = torch.randint(0, g, (n, 1, t_pos), generator=gen, device=gen.device,
                        dtype=torch.int32).repeat(1, g, 1)
    t = torch.arange(t_pos, device=gen.device)
    apart = (t >= start) & ((t < start + 3) if rejoin else True)
    own = torch.arange(g, dtype=torch.int32, device=gen.device)[None, :, None]
    return torch.where(apart[None, None], own, anc).reshape(n * g, t_pos).contiguous()


def _m15_timing_inputs() -> dict:
    """The timed split and per-lane cases' inputs, the same in any tree from
    the same seeds: queries at the beam timing shape, an int8 flat cache, a
    split ancestry a value of M15_FILLS, the per-lane caches (int8, int4) of
    one layer of 40 lanes and their beam-built and all-distinct
    ancestries."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(18)
    rng = np.random.default_rng(18)
    n, g, h = BEAM_N, BEAM_G, BEAM_H
    q = torch.from_numpy(rng.standard_normal((n * g, h, 1, 64)).astype(np.float32) * 0.35).to(
        dev, torch.bfloat16)
    return dict(q=q, cache=_quant_cache(rng, n, h, BEAM_T * g, 8),
                split={fill: (_split_ancestry(gen, fill),
                              torch.full((n,), fill, dtype=torch.int32, device=dev))
                       for fill in M15_FILLS},
                lane={bits: _quant_cache(rng, n * g, h, M15_LANE_T, bits) for bits in (8, 4)},
                lane_anc={kind: _k8_ancestry(kind, gen, n, g, M15_LANE_T)
                          for kind in ("beam", "distinct")})


def _m15_times(inp) -> dict:
    """K8's split (both modes, every M15_FILLS value, beside the flat mode
    at the same ancestry) and per-lane layout (int8 and int4, beam-built
    and all-distinct) at pos 226, device ms a call, L2 cold over copies of
    one layer's cache. Only the wrappers' public calls: any tree's K8 can
    be timed."""
    q, g, pos = inp["q"], BEAM_G, BEAM_POS
    off = torch.zeros((), dtype=torch.bool, device="cuda")
    times = {}
    layers = _copies(inp["cache"])
    for fill, (anc, s_fill) in inp["split"].items():
        for int_dot in (True, False):
            mode = "int_dot" if int_dot else "fp"
            times[f"split int8 {mode} s_fill {fill}"] = _cold_ms(lambda c: bf.beamflat_attention(
                q, *c, anc, pos, g, int_dot=int_dot, s_fill=s_fill, overflow=off), layers)
            times[f"flat int8 {mode} s_fill {fill} ancestry"] = _cold_ms(
                lambda c: bf.beamflat_attention(q, *c, anc, pos, g, int_dot=int_dot), layers)
    del layers
    for bits in (8, 4):
        copies = _copies(inp["lane"][bits])
        for kind, anc in inp["lane_anc"].items():
            times[f"per-lane int{bits} {kind}"] = _cold_ms(
                lambda c: bf.ancestry_attention(q, *c, anc, pos, g), copies)
        del copies
    return times


def _m15_kernels() -> dict:
    """K8's split and per-lane modes alone: each held row by row against its
    plain version on the card (both modes of the split at every s_fill of
    M15_FILLS, at a 16-row tile's edges, on lanes that disagree below
    s_fill, and in clusters past 256 positions with s_fill at 255, 256 and
    a block's edge; the per-lane layout int8 and int4 on beam-built and
    all-distinct ancestries and on agreed runs of 0, 1, 16, 17, pos and pos
    + 1 positions and lanes agreeing again after parting, and the flat
    mode on such runs), bit-equal on a repeat, one device kernel a call;
    the split with its overflow flag set bit-equal to the flat mode; then
    each timed L2 cold (_m15_times) beside its plain version, its bound (the
    distinct rows' bytes, as K8's row) and K8 flat at the same ancestry.
    -> the readings for K8's JSON row."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(26)
    rng = np.random.default_rng(26)
    n, g, h, pos = BEAM_N, BEAM_G, BEAM_H, BEAM_POS
    inp = _m15_timing_inputs()  # checked here, then timed
    q, cache = inp["q"], inp["cache"]
    errs, out = [], {}
    off = torch.zeros((), dtype=torch.bool, device=dev)
    on = torch.ones((), dtype=torch.bool, device=dev)

    def check_split(label, qq, c, anc, p, s_fill, gg=g):
        for int_dot in (False, True):
            name = f"beamflat split {label} {'int_dot' if int_dot else 'fp'}"
            got = bf.beamflat_attention(qq, *c, anc, p, gg, int_dot=int_dot, s_fill=s_fill,
                                        overflow=off)
            errs.append(_check_rows(name, got, bf.beamflat_attention_plain(
                qq, *c, anc, p, gg, int_dot, s_fill)))
            if not torch.equal(got, bf.beamflat_attention(qq, *c, anc, p, gg, int_dot=int_dot,
                                                          s_fill=s_fill, overflow=off)):
                raise AssertionError(f"{name}: a repeat differs")
            if not torch.equal(
                    bf.beamflat_attention(qq, *c, anc, p, gg, int_dot=int_dot, s_fill=s_fill,
                                          overflow=on),
                    bf.beamflat_attention(qq, *c, anc, p, gg, int_dot=int_dot)):
                raise AssertionError(f"{name}: the overflow flag does not give the flat mode")

    for fill, (anc, s_fill) in inp["split"].items():
        check_split(f"s_fill={fill} int8", q, cache, anc, pos, s_fill)
    # s_fill at a 16-row tile's edges, one a window
    edges = (1, 15, 16, 17, 1, 15, 16, 17)
    check_split(f"s_fill={edges} int8", q, cache,
                torch.cat([_split_ancestry(gen, fill, 1) for fill in edges]), pos,
                torch.tensor(edges, dtype=torch.int32, device=dev))
    # lanes that disagree below s_fill: block S reads the first lane's rows
    check_split("disagreeing lanes s_fill=(0, 100, 200, 226, 1, 17, 50, 226) int8", q, cache,
                _k8_ancestry("distinct", gen, n, g, BEAM_T), pos,
                torch.tensor((0, 100, 200, 226, 1, 17, 50, 226), dtype=torch.int32, device=dev))
    # W's agreed run past s_fill (to position 40 or 200), ending at and
    # inside a tile, and lanes agreeing again after parting at 50
    for start, rejoin, fills in ((40, False, (0, 17, 39, 40, 41, 100, 226, 16)),
                                 (200, False, (100, 190, 199, 200, 201, 0, 17, 226)),
                                 (50, True, (0, 49, 50, 51, 52, 53, 60, 226))):
        check_split(f"{'rejoin' if rejoin else 'run'} {start} s_fill={fills} int8", q, cache,
                    _run_ancestry(gen, n, g, BEAM_T, start, rejoin), pos,
                    torch.tensor(fills, dtype=torch.int32, device=dev))
    # clusters of 2, 3 and 8 blocks: s_fill inside a block, at 255 and 256,
    # at a block's edge (224 of 448, 256 of 2048)
    for t_pos, p, gg, fills in ((448, 300, g, (150,)), (448, 447, g, (255, 256)),
                                (448, 447, g, (224, 223)), (600, 599, 11, (255,)),
                                (2048, 2047, g, (1000,)), (2048, 2047, g, (256,))):
        nn = len(fills)
        qq = torch.from_numpy(rng.standard_normal((nn * gg, h, 1, 64)).astype(np.float32)
                              * 0.35).to(dev, torch.bfloat16)
        check_split(f"pos={p} g={gg} s_fill={fills} (cluster {bf.beamflat_plan(p + 1, gg)[0]})",
                    qq, _quant_cache(rng, nn, h, t_pos * gg, 8),
                    torch.cat([_split_ancestry(gen, fill, 1, gg, t_pos) for fill in fills]), p,
                    torch.tensor(fills, dtype=torch.int32, device=dev), gg)
    out["max_abs_err_split"] = max(errs)
    anc100, s100 = inp["split"][100]
    for int_dot in (False, True):
        _one_kernel(f"beamflat split int_dot={int_dot}", lambda: bf.beamflat_attention(
            q, *cache, anc100, pos, g, int_dot=int_dot, s_fill=s100, overflow=off))

    # the per-lane layout: one layer's per-lane cache of 40 lanes; agreed
    # runs (kind, start) of every edge length, also ending in a cluster's
    # later block, and the flat mode on such runs
    runs = [(f"run {start}", start, False) for start in (0, 1, 16, 17, pos, pos + 1)]
    runs.append(("rejoin 40", 40, True))
    lane_errs, lane_caches = [], inp["lane"]
    for bits in (8, 4):
        cases = [(kind, anc, (pos, 255)) for kind, anc in inp["lane_anc"].items()]
        cases += [(kind, _run_ancestry(gen, n, g, M15_LANE_T, start, rejoin), (pos,))
                  for kind, start, rejoin in runs]
        for kind, anc, ps in cases:
            for p in ps:
                got = bf.ancestry_attention(q, *lane_caches[bits], anc, p, g)
                ref = bf.attention_int8_ancestry_plain(q, *lane_caches[bits], anc, p, g)
                lane_errs.append(_check_rows(f"beamflat per-lane int{bits} {kind} pos={p}",
                                             got, ref))
                if not torch.equal(got, bf.ancestry_attention(q, *lane_caches[bits], anc, p, g)):
                    raise AssertionError(f"beamflat per-lane int{bits} {kind}: a repeat differs")
        for t_pos, p, start, rejoin in ((448, 447, 230, False), (448, 447, 100, True)):
            anc = _run_ancestry(gen, 2, g, t_pos, start, rejoin)
            c = _quant_cache(rng, 2 * g, h, t_pos, bits)
            lane_errs.append(_check_rows(
                f"beamflat per-lane int{bits} {'rejoin' if rejoin else 'run'} {start} pos={p} "
                f"(cluster {bf.beamflat_plan(p + 1, g)[0]})",
                bf.ancestry_attention(q[:2 * g], *c, anc, p, g),
                bf.attention_int8_ancestry_plain(q[:2 * g], *c, anc, p, g)))
        # the flat mode takes the same run route
        c = _quant_cache(rng, n, h, BEAM_T * g, bits)
        for kind, start, rejoin in runs[2:4] + runs[-1:]:
            anc = _run_ancestry(gen, n, g, BEAM_T, start, rejoin)
            for int_dot in (False, True):
                lane_errs.append(_check_rows(
                    f"beamflat flat int{bits} {'int_dot' if int_dot else 'fp'} {kind}",
                    bf.beamflat_attention(q, *c, anc, pos, g, int_dot=int_dot),
                    bf.beamflat_attention_plain(q, *c, anc, pos, g, int_dot=int_dot)))
        del c
    out["max_abs_err_lane"] = max(lane_errs)
    anc_beam = inp["lane_anc"]["beam"]
    runs_beam = bf.beamflat_agreed_runs(anc_beam, g, pos, 1)
    print(f"  beamflat per-lane beam-built ancestry at pos {pos}: agreed runs of "
          f"{runs_beam.min().item()}-{runs_beam.max().item()} of {pos + 1} positions a window "
          f"(mean {runs_beam.float().mean().item():.1f})")
    _one_kernel("beamflat per-lane int8", lambda: bf.ancestry_attention(
        q, *lane_caches[8], anc_beam, pos, g))

    # times, L2 cold over copies of one layer's cache
    times = _m15_times(inp)
    split_cases = {}
    for fill, (anc, s_fill) in inp["split"].items():
        needed = int(bf.beamflat_rows_needed(anc, g, pos, s_fill).sum())
        for int_dot in (True, False):
            mode = "int_dot" if int_dot else "fp"
            label = f"int8 {mode} s_fill {fill}"
            ms, flat = times[f"split {label}"], times[f"flat int8 {mode} s_fill {fill} ancestry"]
            bound = _bound(needed * h * (2 * 64 + 4) + n * g * (pos + 1) * 4 + 2 * _nbytes(q),
                           n * g * h * (pos + 1) * 2 * 2 * 64, "int8" if int_dot else "bf16")
            split_cases[label] = dict(ms=ms, flat_ms=flat, distinct_rows=needed, **bound)
            print(f"  beamflat split {label}: kernel {ms:.4f} ms, K8 flat at the same ancestry "
                  f"{flat:.4f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}, {needed} "
                  f"distinct rows), {bound['bound_ms'] / ms:.1%} of it")
    main = split_cases[f"int8 int_dot s_fill {M15_FILLS[1]}"]
    anc100, s100 = inp["split"][100]
    out.update(ms_split=main["ms"], bound_split_ms=main["bound_ms"],
               bound_split_by=main["bound_by"], flat_ms_split_shape=main["flat_ms"],
               cases_split=split_cases, plain_split_ms=_cold_ms(
                   lambda c: bf.beamflat_attention_plain(q, *c, anc100, pos, g, True, s100),
                   _copies(cache, 2), reps=8), library_split_ms=None)
    lane_cases = {}
    for bits in (8, 4):
        for kind, anc in inp["lane_anc"].items():
            needed = int(bf.beamflat_rows_needed(anc, g, pos).sum())
            ms = times[f"per-lane int{bits} {kind}"]
            bound = _bound(needed * h * (2 * bits * 64 // 8 + 4) + n * g * (pos + 1) * 4
                           + 2 * _nbytes(q), n * g * h * (pos + 1) * 2 * 2 * 64, "bf16")
            lane_cases[f"int{bits} {kind}"] = dict(ms=ms, distinct_rows=needed, **bound)
            print(f"  beamflat per-lane int{bits} {kind} pos {pos}: kernel {ms:.4f} ms, bound "
                  f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}, {needed} distinct rows), "
                  f"{bound['bound_ms'] / ms:.1%} of it")
    main = lane_cases["int8 beam"]
    out.update(ms_lane=main["ms"], bound_lane_ms=main["bound_ms"],
               bound_lane_by=main["bound_by"], cases_lane=lane_cases, plain_lane_ms=_cold_ms(
                   lambda c: bf.attention_int8_ancestry_plain(q, *c, anc_beam, pos, g),
                   _copies(lane_caches[8], 2), reps=8), library_lane_ms=None)
    return out


def _m15_counts() -> dict:
    return {"mel": mk.LAUNCHES, "dense": dn.LAUNCHES, "decode": da.LAUNCHES,
            "decode_int": da.INT_DOT_LAUNCHES, "beamflat": bf.LAUNCHES,
            "beamflat_split": bf.SPLIT_LAUNCHES, "beamflat_lane": bf.LANE_LAUNCHES,
            "flash": fa.LAUNCHES, "quant": qm.LAUNCHES}


def _zero_m15_counts() -> None:
    _zero_counts()
    bf.SPLIT_LAUNCHES = bf.LANE_LAUNCHES = fa.LAUNCHES = qm.LAUNCHES = 0


@contextlib.contextmanager
def _uncounted():
    """Launches made inside (a comparison's) left out of the counts."""
    saved = dict(mel=mk.LAUNCHES, dense=dn.LAUNCHES, decode=da.LAUNCHES,
                 decode_int=da.INT_DOT_LAUNCHES, beamflat=bf.LAUNCHES, split=bf.SPLIT_LAUNCHES,
                 lane=bf.LANE_LAUNCHES, flash=fa.LAUNCHES, quant=qm.LAUNCHES,
                 permute=lp.PERMUTE_LAUNCHES, move=lp.MOVE_LAUNCHES)
    try:
        yield
    finally:
        mk.LAUNCHES, dn.LAUNCHES, da.LAUNCHES = saved["mel"], saved["dense"], saved["decode"]
        da.INT_DOT_LAUNCHES, bf.LAUNCHES = saved["decode_int"], saved["beamflat"]
        bf.SPLIT_LAUNCHES, bf.LANE_LAUNCHES = saved["split"], saved["lane"]
        fa.LAUNCHES, qm.LAUNCHES = saved["flash"], saved["quant"]
        lp.PERMUTE_LAUNCHES, lp.MOVE_LAUNCHES = saved["permute"], saved["move"]


class _BeamTrace:
    """While in use: the beam loop's top-2B candidates a step and the
    TRACE_EXTRA after them (scores and flat indices, on the host; the loop
    gets its 2B) and, with ``teacher``, the largest
    difference of the log-softmax of each step's logits from the same step
    with K8's plain version on a copy of the cache (D, on the run's own
    trajectory); with ``plain``, K8's plain version in the kernel's place."""

    def __init__(self, plain: bool = False, teacher: bool = False):
        self.plain, self.teacher, self.tops, self.d = plain, teacher, [], 0.0

    def __enter__(self):
        self.topk, self.step = tb._topk_flat, tb.decode_step

        def topk(cand, k):
            self.k = k
            scores, idx = self.topk(cand, k + TRACE_EXTRA)  # its first k are the top k
            self.tops.append((scores.float().cpu(), idx.cpu()))
            return scores[:, :k], idx[:, :k]

        def step(params, tokens, pos, cache, *a, **kw):
            if not (self.teacher and "beam_ancestry" in kw):
                return self.step(params, tokens, pos, cache, *a, **kw)
            copy = [{k: v.clone() for k, v in e.items()} for e in cache]
            out = self.step(params, tokens, pos, cache, *a, **kw)
            tw.beamflat_attention = bf.beamflat_attention_plain
            try:
                with _uncounted():
                    ref = self.step(params, tokens, pos, copy, *a, **kw)
            finally:
                tw.beamflat_attention = bf.beamflat_attention
            diff = (torch.log_softmax(out[0][:, -1].float(), -1)
                    - torch.log_softmax(ref[0][:, -1].float(), -1)).abs().max().item()
            self.d = max(self.d, diff)
            return out

        tb._topk_flat, tb.decode_step = topk, step
        if self.plain:
            tw.beamflat_attention = bf.beamflat_attention_plain
        return self

    def __exit__(self, *exc):
        tb._topk_flat, tb.decode_step = self.topk, self.step
        tw.beamflat_attention = bf.beamflat_attention


def _beam_tie_check(label, kernel: _BeamTrace, plain: _BeamTrace, d: float) -> None:
    """Hold a beam run's candidates against the same run's with K8's plain
    version: in each window, where they first choose differently, the plain
    run's gap between its candidate and the kernel's must be within
    SPEC_TIE_FACTOR times the larger of 2 D (two candidates each moved by
    up to D) and the largest score difference of the candidates both runs
    hold at that step."""
    k = kernel.k
    for w in range(kernel.tops[0][0].shape[0]):
        for step, ((sk, ik), (sp, ip)) in enumerate(zip(kernel.tops, plain.tops)):
            if torch.equal(ik[w, :k], ip[w, :k]):
                continue
            rank = int((ik[w, :k] != ip[w, :k]).nonzero()[0])
            ik_w, ip_w = ik[w].tolist(), ip[w].tolist()
            moved = max((abs(float(sk[w][ik_w.index(c)]) - float(sp[w][ip_w.index(c)]))
                         for c in set(ik_w) & set(ip_w)), default=0.0)
            tol = SPEC_TIE_FACTOR * max(2 * d, moved)
            where = (ip[w] == ik[w][rank]).nonzero().flatten()
            if where.numel() == 0:
                raise AssertionError(f"{label}: window {w} step {step}: the kernel's candidate "
                                     f"is not among the plain run's first {k + TRACE_EXTRA}")
            gap = float(sp[w][rank] - sp[w][int(where[0])])
            print(f"  {label}: window {w} parts from the plain version at step {step}, rank "
                  f"{rank}: the plain run's gap {gap:.4e}, near-tie limit {tol:.4e} (D {d:.4e}, "
                  f"scores moved {moved:.4e})")
            if not gap <= tol:
                raise AssertionError(f"{label}: window {w} parts at step {step} with a gap of "
                                     f"{gap} > {tol}")
            break
        else:
            print(f"  {label}: window {w} equal to the plain version's at every step")


def _m15_whisper(totals: dict) -> None:
    """large-v3 (bf16, int4 cross, int8 self, random weights of seed 0) on
    2 windows of noise: greedy under each time-major field, tokens equal to
    the time-minor run's bit for bit; beam 5 under WTPU_BEAM_KV=shared at
    each read window of M15_WINDOWS, beside the same batch with K8's plain
    version (a near tie at any parting); beam 5 with a time-major cross
    cache; decode_step with beam_ancestry over a per-lane cache (F9) against
    the same step with K8's plain version."""
    dev = torch.device("cuda")
    base = WHISPER_CONFIGS["large-v3"]
    params, config = apply_asr_serving_config(
        init_params(base, seed=0, device=dev, dtype=torch.bfloat16), base, dev)
    tok = _bench_tokenizer(config.n_vocab)
    audio = torch.from_numpy(np.random.default_rng(26).standard_normal((2, N_SAMPLES)).astype(
        np.float32) * 0.1).to(dev)
    _zero_m15_counts()
    with torch.inference_mode():
        mel = torch.stack([log_mel_spectrogram(a, config.n_mels) for a in audio])
        states = encode(params, mel, config)
    torch.cuda.synchronize()
    totals.update(mel=mk.LAUNCHES, dense=dn.LAUNCHES)

    def run(label, cfg, opts, env=None, trace=None, count=True):
        _zero_m15_counts()
        t0 = time.perf_counter()
        with _Env(**(env or {})), (trace or contextlib.nullcontext()), torch.inference_mode():
            res = decode(params, states, tok, cfg, opts, states_precomputed=True)
        torch.cuda.synchronize()
        counts = _m15_counts()
        for key, v in counts.items():
            totals[key] = totals.get(key, 0) + (v if count else 0)
        print(f"  {label}: {time.perf_counter() - t0:.2f} s, {sum(len(r.tokens) for r in res)} "
              f"tokens, launches {counts}")
        assert all(r.tokens and np.isfinite(r.avg_logprob) for r in res), label
        return res, counts

    greedy = DecodingOptions(sample_len=M15_LEN)
    base_tokens, _ = run("greedy, time-minor caches", config, greedy)
    for field in ("self_kv_layout", "kv_layout"):
        res, counts = run(f"greedy, {field}=tmajor", dataclasses.replace(config, **{field:
                                                                                  "tmajor"}),
                          greedy)
        assert _tokens(res) == _tokens(base_tokens), f"{field}=tmajor: tokens differ"
        assert counts["decode"] > 0 and counts["decode_int"] == 0, counts
    beam = DecodingOptions(sample_len=M15_LEN, beam_size=5)
    for window in M15_WINDOWS:
        env = dict(WTPU_BEAM_KV="shared", WTPU_BEAM_WIN=window)
        last = {}
        commits = tb._shared_commits

        def spy(*a, **kw):
            last["out"] = commits(*a, **kw)
            return last["out"]

        tb._shared_commits = spy
        try:
            kernel = _BeamTrace(teacher=True)
            res, counts = run(f"beam 5, WTPU_BEAM_KV=shared, WTPU_BEAM_WIN={window}", config,
                              beam, env, kernel)
            s_fill, overflow = (t.tolist() for t in last["out"])
        finally:
            tb._shared_commits = commits
        assert counts["beamflat_split"] > 0, counts
        print(f"    last s_fill {s_fill}, overflow {overflow} (D {kernel.d:.4e})")
        if window == min(M15_WINDOWS):
            assert overflow, f"W={window}: the overflow never took over"
        plain = _BeamTrace(plain=True)
        ref, _ = run("the same with K8's plain version", config, beam, env, plain, count=False)
        same, total = _agreement(res, ref)
        print(f"    against K8's plain version: tokens agree {same}/{total}")
        _beam_tie_check(f"shared W={window}", kernel, plain, kernel.d)
    res, counts = run("beam 5, kv_layout=tmajor (the cross cache in K3's fp mode)",
                      dataclasses.replace(config, kv_layout="tmajor"), beam)
    assert counts["decode"] > 0, counts

    # F9: decode_step(beam_ancestry=) over a per-lane cache, 2 windows x 5
    _zero_m15_counts()
    cache = init_kv_cache(config, 10, dev, max_len=M15_LEN)
    xkv = cross_kv(params, states, config)
    init = torch.tensor([tok.sot_sequence] * 10, device=dev)
    with torch.inference_mode():
        decode_step(params, init, 0, cache, xkv, config, share_xkv_groups=5)
        gen = torch.Generator(device=dev).manual_seed(9)
        t_alloc = cache[0]["k8"].shape[2]
        anc = _beam_ancestry(gen, 2, 5, t_alloc)
        step = init[:, :1]
        pos = len(tok.sot_sequence)
        copy = [{k: v.clone() for k, v in e.items()} for e in cache]
        got = decode_step(params, step, pos, cache, xkv, config, share_xkv_groups=5,
                          beam_ancestry=anc)[0]
        lanes = bf.LANE_LAUNCHES
        tw.ancestry_attention = bf.attention_int8_ancestry_plain
        try:
            ref = decode_step(params, step, pos, copy, xkv, config, share_xkv_groups=5,
                              beam_ancestry=anc)[0]
        finally:
            tw.ancestry_attention = bf.ancestry_attention
    totals["beamflat_lane"] = totals.get("beamflat_lane", 0) + lanes
    totals["beamflat"] = totals.get("beamflat", 0) + lanes
    assert lanes == config.n_text_layer, lanes
    _check("F9: decode_step(beam_ancestry=) over a per-lane cache, large-v3 logits against K8's "
           "plain version", got, ref, TINY_LOGIT_TOL * max(1.0, ref.float().abs().max().item()))


def _m15_qwen(totals: dict) -> None:
    """Qwen3-32B at full width and RESIDENCY_LAYERS layers (random packed
    int4 weights built on the card) under WTPU_NATIVE_RESIDENT=1: 32 tokens
    at B = 1 through LLMEngine.generate beside the packed engine's (equal up
    to a near tie: the packed run's gap at the parting within
    SPEC_TIE_FACTOR times D, the largest logit difference of the two
    teacher-forced on the native run's tokens), and one 128-token prefill
    past the row rule (dequantize + matmul, no K5) beside the packed
    prefill (K5's tiled core)."""
    dev = torch.device("cuda")
    config = dataclasses.replace(QWEN32, dtype=torch.bfloat16, flash_attention=True,
                                 num_hidden_layers=RESIDENCY_LAYERS)
    packed = qw.init_random_quant_params(config, seed=0, device=dev)
    tok = ByteFallbackTokenizer()
    with _Env(WTPU_NATIVE_RESIDENT=1):
        native = LLMEngine(packed, config, tok, max_context=4096)
    def weights(node):
        if isinstance(node, dict):
            return [w for k, v in node.items() for w in ([v] if k == "w" else weights(v))]
        return [w for v in node for w in weights(v)] if isinstance(node, list) else []

    kinds = {type(w).__name__ for w in weights(native.params)}
    assert kinds == {"NativeQuantTensor"}, kinds
    assert isinstance(native.params["embed"], tq.NativeQuantTensor)
    plain = LLMEngine(packed, config, tok, max_context=4096)
    prompt = _prompt_text(np.random.default_rng(26), 270)
    ids = tok.encode(prompt)
    native.generate("warm up", max_tokens=4, temperature=0.0)
    _zero_m15_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = native.generate(prompt, max_tokens=32, temperature=0.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _m15_counts()
    for key in ("flash", "quant"):
        totals[key] = totals.get(key, 0) + counts[key]
    assert res.generation_tokens == 32 and counts["quant"] > 0, (res.generation_tokens, counts)
    print(f"  Qwen3-32B ({RESIDENCY_LAYERS} layers) WTPU_NATIVE_RESIDENT=1: {len(ids)}-token "
          f"prompt, 32 tokens in {wall:.3f} s ({32 / wall:.2f} tok/s), launches {counts}")
    ref = plain.generate(prompt, max_tokens=32, temperature=0.0).tokens
    first = _first_difference(res.tokens, ref)
    upto = 32 if first is None else first + 1
    with torch.inference_mode():
        rows_n = _engine_logits(native.params, config, ids, res.tokens[:upto])
        rows_p = _engine_logits(packed, config, ids, res.tokens[:upto])
    d = (rows_n - rows_p).abs().max().item()
    same = sum(x == y for x, y in zip(res.tokens, ref))
    msg = (f"  native against packed: {same}/32 tokens agree, first difference at {first}; "
           f"largest logit difference D {d:.4e}, near-tie limit {SPEC_TIE_FACTOR * d:.4e}")
    if first is not None:
        gap = (rows_p[first][ref[first]] - rows_p[first][res.tokens[first]]).item()
        msg += f"; the packed run's gap there {gap:.4e}"
        if not gap <= SPEC_TIE_FACTOR * d:
            raise AssertionError(f"native residency: tokens part from the packed engine's at "
                                 f"{first} with a gap of {gap} > {SPEC_TIE_FACTOR * d}")
    print(msg)
    del rows_n, rows_p
    # one 128-token prefill: past the row rule every linear dequantizes
    prefill = torch.tensor([ids[:128]], device=dev)
    outs = {}
    for label, p in (("native", native.params), ("packed", packed)):
        cache = qw.init_kv_cache(config, 1, 256, dev)
        _zero_m15_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            outs[label] = qw.decode_step(p, prefill, 0, cache, config)[0][0, -1].float()
        torch.cuda.synchronize()
        counts = _m15_counts()
        print(f"  128-token prefill, {label}: {(time.perf_counter() - t0) * 1e3:.1f} ms wall, "
              f"launches K4 {counts['flash']}, K5 {counts['quant']}")
        if label == "native":
            assert counts["quant"] == 0 and counts["flash"] > 0, counts
            totals["flash"] = totals.get("flash", 0) + counts["flash"]
    _check("native 128-token prefill logits against the packed prefill's (K5 tiled)",
           outs["native"], outs["packed"],
           TINY_LOGIT_TOL * max(1.0, outs["packed"].abs().max().item()))


def phase_m15() -> dict:
    """Phase 26: the reference's last opt-ins (ROADMAP M15) and fault F9.
    K8's split and per-lane modes alone (_m15_kernels); large-v3 on 2
    windows (_m15_whisper); Qwen3-32B under WTPU_NATIVE_RESIDENT=1
    (_m15_qwen). -> K8's readings and the launches of K1-K5 and K8 (its
    split and per-lane modes apart) over the phase's main-path runs (the
    comparison runs left out)."""
    t_phase = time.perf_counter()
    rows = _m15_kernels()
    print(f"  (K8's modes alone: {time.perf_counter() - t_phase:.1f} s)")
    gc.collect()
    torch.cuda.empty_cache()
    totals: dict = {}
    t0 = time.perf_counter()
    _m15_whisper(totals)
    print(f"  (large-v3: {time.perf_counter() - t0:.1f} s)")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _m15_qwen(totals)
    print(f"  (Qwen3-32B: {time.perf_counter() - t0:.1f} s)")
    print(f"  launches over the phase's main-path runs: {totals}")
    for key in ("mel", "dense", "decode", "decode_int", "beamflat", "beamflat_split",
                "beamflat_lane", "flash", "quant"):
        assert totals.get(key, 0) > 0, f"kernel {key} was not launched on phase 26's path"
    print(f"m15: {_smi()}")
    return {"rows": rows, "launches": totals}


def _encoder_dequant_cost(params, dense, config, mel) -> None:
    """The encoder on packed weights dequantizes each of its linears at every
    call (1500 rows a window is past the kernels' 512): its time beside the
    same encoder on weights dequantized once."""
    def timed(p):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encode(p, mel, config)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    with torch.inference_mode():
        timed(params), timed(dense)
        packed_ms, dense_ms = min(timed(params) for _ in range(2)), min(timed(dense) for _ in range(2))
    print(f"  encoder, {mel.shape[0]} windows: {packed_ms:.1f} ms on packed weights (192 "
          f"dequantizations a call), {dense_ms:.1f} ms on weights dequantized once: "
          f"{packed_ms - dense_ms:.1f} ms of dequantization")


# ---------------------------------------------------------------------------
# multi-device parallelism (ROADMAP M14): a world of one on NCCL, then two
# ranks sharing the card over gloo
# ---------------------------------------------------------------------------

M14_TP_STEPS = 16  # (b2): large-v3 decode steps at tp 2 (cut from 64 for the time limit)
M14_QWEN_LAYERS = 8  # (b3): of Qwen3-32B's 64; every width is full
M14_QWEN_STEPS = 16  # (b3): decode steps after the prefill
M14_RANKS_TIMEOUT_S = 420


def _m14_zero() -> None:
    _zero_counts()
    fa.LAUNCHES = qm.LAUNCHES = qm.TILED_LAUNCHES = gq.LAUNCHES = 0


def _m14_counts() -> dict:
    return {"mel": mk.LAUNCHES, "dense": dn.LAUNCHES, "decode": da.LAUNCHES,
            "flash": fa.LAUNCHES, "quant": qm.LAUNCHES, "gqa": gq.LAUNCHES}


def _m14_add(totals: dict, counts: dict) -> None:
    for key, n in counts.items():
        totals[key] = totals.get(key, 0) + n


def _m14_tokens(results) -> list:
    return [r.tokens for r in results]


def _m14_check_k5(label: str, q, m: int, gen) -> float:
    """K5 on one tp-2 shard leaf at ``m`` rows against its plain version:
    within QMM_TOL x max(1, |ref|) (phase 7's limit), bit-equal on a
    repeat. -> the error."""
    n, k = q.shape
    x = torch.randn((m, k), generator=gen, device=gen.device).to(torch.bfloat16)
    got = tq.quant_matmul(x, q)
    ref = _k5_plain(x, q)
    err = _check(f"quant_matmul tp-2 shard {label} N={n} K={k} M={m}", got, ref,
                 QMM_TOL * max(1.0, ref.float().abs().max().item()))
    if not torch.equal(got, tq.quant_matmul(x, q)):
        raise AssertionError(f"quant_matmul tp-2 shard {label} M={m}: a repeat is not bit-equal")
    return err


def _m14_shard_kernels() -> None:
    """The kernels at the shapes phase 27's tp-2 ranks give them, each
    against its plain version on the same inputs and bit-equal on a repeat:
    K2 over 10 of large-v3's 20 heads (2 windows), K3 over 10 heads (the
    int8 self cache at the SOT block and a step, the int4 cross cache), K4
    at 32 query over 4 KV heads (the 270-token prefill), K3's GQA mode over
    4 KV heads (int8, the decode's first and last positions), each query
    row within ATTN_TOL of its max|ref|; K5 on every leaf of a rank's shard
    of a Qwen3-32B layer and its head (column shards qkv, gate_up, lm_head;
    row shards o over K 4096 and down over K 12800, cut by
    parallel/sharding_llm.py as the ranks cut them) at M = 1 and the
    prefill's 270 rows, within QMM_TOL x max(1, |ref|)."""
    from whisper_mlx_tpu_torch.parallel.mesh import Mesh
    from whisper_mlx_tpu_torch.parallel.sharding_llm import shard_qwen_params

    dev = torch.device("cuda")
    rng = np.random.default_rng(27)
    gen = torch.Generator(device=dev).manual_seed(27)

    def bf(shape, std):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * std).to(
            dev, torch.bfloat16)

    def repeat(label, got, call):
        if not torch.equal(got, call()):
            raise AssertionError(f"{label}: a repeat is not bit-equal")

    q, k, v = bf((2, 10, 1500, 64), 0.35), bf((2, 10, 1500, 64), 0.35), bf((2, 10, 1500, 64), 1)
    label = "dense_attention tp-2 shard B=2 H=10 T=1500"
    got = dn.dense_attention(q, k, v)
    _check_rows(label, got, dn.dense_attention_plain(q, k, v))
    repeat(label, got, lambda: dn.dense_attention(q, k, v))
    self_c, cross_c = _quant_cache(rng, 2, 10, 448, 8), _quant_cache(rng, 2, 10, 1500, 4)
    for name, rows, c, kw in (("self int8 Tq=4 pos=0", 4, self_c, dict(pos=0, causal=True)),
                              ("self int8 Tq=1 pos=35", 1, self_c, dict(pos=35, causal=True)),
                              ("cross int4 Tq=4", 4, cross_c, dict(valid_len=1500)),
                              ("cross int4 Tq=1", 1, cross_c, dict(valid_len=1500))):
        qd = bf((2, 10, rows, 64), 0.35)
        label = f"decode_attention tp-2 shard B=2 H=10 {name}"
        got = da.decode_attention(qd, *c, **kw)
        _check_rows(label, got, da.decode_attention_plain(qd, *c, **kw))
        repeat(label, got, lambda: da.decode_attention(qd, *c, **kw))
    s = 128 ** -0.25
    qf = (torch.randn((1, 32, 270, 128), generator=gen, device=dev) * s).to(torch.bfloat16)
    kf = (torch.randn((1, 4, 270, 128), generator=gen, device=dev) * s).to(torch.bfloat16)
    vf = torch.randn((1, 4, 270, 128), generator=gen, device=dev).to(torch.bfloat16)
    label = "flash_attention tp-2 shard H=32 KV=4 T=270 causal"
    got = fa.flash_attention(qf, kf, vf, causal=True)
    _check_rows(label, got, fa.flash_attention_plain(qf, kf, vf, causal=True))
    repeat(label, got, lambda: fa.flash_attention(qf, kf, vf, causal=True))
    for pos in (270, 285):
        qg, cache, p, kw = _gqa_inputs(gen, 4, 8, 128, [pos], 1, 294, 8)
        label = f"gqa tp-2 shard int8 KV=4 rep=8 hd=128 pos={pos} T=294"
        got = gq.gqa_decode_attention(qg, *cache, p, out_dtype=torch.bfloat16, **kw)
        _check_rows(label, got, gq.gqa_decode_attention_plain(qg, *cache, p, **kw))
        repeat(label, got, lambda: gq.gqa_decode_attention(qg, *cache, p,
                                                           out_dtype=torch.bfloat16, **kw))
    del q, k, v, self_c, cross_c, qf, kf, vf
    config = dataclasses.replace(QWEN32, num_hidden_layers=1, dtype=torch.bfloat16)
    params = qw.init_random_quant_params(config, seed=0, device=dev)
    local = shard_qwen_params(params, Mesh(dp=1, tp=2, rank=0, device=dev), config=config)
    del params
    blk = local["layers"][0]
    leaves = dict(qkv=blk["attn"]["qkv"]["w"], o=blk["attn"]["o"]["w"],
                  gate_up=blk["mlp"]["gate_up"]["w"], down=blk["mlp"]["down"]["w"],
                  lm_head=local["lm_head"]["w"])
    for name, leaf in leaves.items():
        for m in (1, 270):
            _m14_check_k5(name, leaf, m, gen)
    del local, blk, leaves
    torch.cuda.empty_cache()


def _m14_world_of_one(totals: dict) -> None:
    """(a) One process in an NCCL group of world size 1, make_mesh(dp=1,
    tp=1): transcribe(batch_windows=True, mesh=) over phase 22's 65 s file on
    large-v3, whose tokens must equal the meshless run's bit for bit."""
    import torch.distributed as dist

    from whisper_mlx_tpu_torch.parallel.launch import free_port
    from whisper_mlx_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device("cuda")
    base = WHISPER_CONFIGS["large-v3"]
    params, config = apply_asr_serving_config(
        init_params(base, seed=0, device=dev, dtype=torch.bfloat16), base, dev)
    tok = _wordy_tokenizer(config.n_vocab)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(dp=1, tp=1)
        with tempfile.TemporaryDirectory() as tmp:
            wav = os.path.join(tmp, "req0.wav")
            _write_wav(wav, 65.0)
            kw = dict(params=params, config=config, device=dev, temperature=0.0,
                      batch_windows=True, sample_len=BATCH_SAMPLE_LEN,
                      no_speech_threshold=None, language="en", verbose=False)
            ref = transcribe_mod.transcribe(wav, tokenizer=_wordy_tokenizer(config.n_vocab),
                                            **kw)
            _m14_zero()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = transcribe_mod.transcribe(wav, tokenizer=tok, mesh=mesh, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = _m14_counts()
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    same = [s["tokens"] for s in got["segments"]] == [s["tokens"] for s in ref["segments"]]
    print(f"  m14 (a) world of one, backend {backend}, make_mesh(dp=1, tp=1): "
          f"transcribe(batch_windows=True, mesh=) on the 65 s file, {len(got['segments'])} "
          f"segments, {sum(len(s['tokens']) for s in got['segments'])} tokens, bit-equal to "
          f"the meshless run: {same}; wall {wall:.3f} s, launches {counts}")
    assert same and got["text"] == ref["text"], "(a) the mesh of one changed the tokens"
    _m14_add(totals, counts)


def _m14_dp(rank: int, params, config, tok, dev, mesh, lines: list) -> dict:
    """(b1) dp 2: phase 22's burst of four requests (8 windows) through
    TranscriptionBatcher(mesh=), rank 0 holding the queue and rank 1
    following, in one bucket of 8 at a raised flush, so that the burst rides
    one batch (4 windows a rank). Each rank's tokens are held bit for bit to a meshless
    run of its own 4 windows. -> the launches of the burst."""
    from whisper_mlx_tpu_torch.parallel.sharding import shard_batch

    batcher = TranscriptionBatcher(params, config, tok, device=dev, mesh=mesh, batch_size=8,
                                   decoding=DecodingOptions(sample_len=BATCH_SAMPLE_LEN),
                                   max_wait_ms=CHECKED_FLUSH[0], idle_gap_ms=CHECKED_FLUSH[1])
    slices, run_slice = [], batcher._run_slice

    def spy(mel):
        out = run_slice(mel)
        slices.append((mel.clone(), out))
        return out

    batcher._run_slice = spy
    seconds = (65.0, 30.0, 20.0, 65.0)
    _m14_zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if rank == 0:
        with tempfile.TemporaryDirectory() as tmp:
            audios = []
            for i, sec in enumerate(seconds):
                path = os.path.join(tmp, f"req{i}.wav")
                _write_wav(path, sec)
                audios.append(load_audio_serving(path))
        results, _ = _burst(batcher, audios)
        _check_segments(results, seconds)
        batches = batcher.stats["batches"]
    else:
        batches = batcher.follow()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _m14_counts()
    assert batches == 1 and len(slices) == 1, f"(b1) {batches} batches: expected one of 8"
    mel, gathered = slices[0]
    local = shard_batch(mel, mesh)
    start = mesh.index("dp") * local.shape[0]
    with torch.inference_mode():
        alone = decode(params, encode(params, local, config), tok, config, batcher.decoding,
                       states_precomputed=True)
    mine = _m14_tokens(gathered[start:start + local.shape[0]])
    same = mine == _m14_tokens(alone)
    lines.append(f"(b1) dp 2: the burst of {len(seconds)} requests (8 windows) in {batches} "
                 f"batch of {mel.shape[0]}, windows {start}-{start + local.shape[0] - 1} on "
                 f"this rank; wall {wall:.3f} s; launches {counts}; tokens bit-equal to a "
                 f"meshless run of the same {local.shape[0]} windows: {same}")
    assert same, f"(b1) rank {rank}: its windows' tokens differ from the meshless run's"
    if rank == 0:
        with torch.inference_mode():
            whole = decode(params, encode(params, mel, config), tok, config, batcher.decoding,
                           states_precomputed=True)
        agree, total = _agreement(gathered, whole)
        lines.append(f"(b1) the 8 gathered windows beside a meshless run of all 8: "
                     f"{agree}/{total} tokens agree")
    return counts


class _M14Spy:
    """greedy's ``decode_step`` while in use: each call's last-position
    logits (fp32) and the collectives it ran."""

    def __enter__(self):
        from whisper_mlx_tpu_torch.decoding import greedy
        from whisper_mlx_tpu_torch.parallel import mesh as mesh_mod

        self.module, self.real = greedy, greedy.decode_step
        self.logits, self.collectives = [], []

        def spy(*a, **kw):
            before = dict(mesh_mod.COUNTS)
            out = self.real(*a, **kw)
            self.logits.append(out[0][:, -1].float())
            self.collectives.append({k: mesh_mod.COUNTS[k] - before[k] for k in before})
            return out

        greedy.decode_step = spy
        return self

    def __exit__(self, *exc):
        self.module.decode_step = self.real


def _m14_d(ref_logits: list, got_logits: list, ref_toks: list, got_toks: list) -> float:
    """D: the largest logit difference between two greedy runs over the
    steps both take on the same tokens, up to and with their first parting."""
    first = _first_difference(ref_toks, got_toks)
    last = min(len(ref_logits), len(got_logits)) - 1 if first is None else first
    return max(float((a - b).abs().max())
               for a, b in zip(ref_logits[:last + 1], got_logits[:last + 1]))


class _M14Stream:
    """While in use: the residual stream at the input of each call of
    ``module.name`` (whisper's layer_norm, Qwen's rms_norm) on a tensor
    ``width`` wide, in call order. Without ``ref`` the tensors are kept;
    with ``ref`` (a first run's tensors) each point's max|err| over
    max(1, max|ref|) is kept instead."""

    def __init__(self, module, name: str, width: int, ref: list | None = None):
        self.module, self.name, self.width, self.ref, self.points = module, name, width, ref, []

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def spy(x, *a, **kw):
            if x.shape[-1] == self.width:
                if self.ref is None:
                    self.points.append(x.clone())
                elif len(self.points) < len(self.ref):
                    r = self.ref[len(self.points)].float()
                    self.points.append(float((x.float() - r).abs().max())
                                       / max(1.0, float(r.abs().max())))
            return self.real(x, *a, **kw)

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


class _M14Plain:
    """While in use, the models run every kernel of phase 27's paths as its
    plain version on the card: K2, K3, K3's GQA mode, K4 and K5 (a
    comparison run's, launching none of them)."""

    def __enter__(self):
        real = tq.quant_matmul

        def qmm(x, q):
            if isinstance(q, tq.QuantTensor) and x.numel() // x.shape[-1] <= 512:
                return _k5_plain(x, q).to(x.dtype)
            return real(x, q)

        self.saved = [(m, n, getattr(m, n)) for m, n in (
            (tw, "dense_attention"), (tw, "decode_attention"), (tw, "flash_attention"),
            (tw, "quant_matmul"), (qw, "flash_attention"), (qw, "gqa_decode_attention"),
            (qw, "quant_matmul"))]
        tw.dense_attention, tw.decode_attention = dn.dense_attention_plain, da.decode_attention_plain
        tw.flash_attention = qw.flash_attention = fa.flash_attention_plain
        qw.gqa_decode_attention = gq.gqa_decode_attention_plain
        tw.quant_matmul = qw.quant_matmul = qmm
        return self

    def __exit__(self, *exc):
        for m, n, f in self.saved:
            setattr(m, n, f)


def _m14_growth(errs: list, marks: dict) -> str:
    return ", ".join(f"{name} {errs[i]:.3e}" for name, i in marks.items() if i < len(errs))


def _m14_check_stem(label: str, errs: list) -> None:
    """The stream before the first block (the conv stem, replicated, or the
    vocabulary lookup, masked and summed over "tp") bit-equal at tp 2."""
    assert errs[0] == 0.0, f"{label}: the stream differs before the first block ({errs[0]})"


def _m14_marks(name: str, n: int, index) -> dict:
    """Points of the stream to print: after blocks 1, 2, 4, ... and the last."""
    blocks = sorted({b for b in (1, 2, 4, 8, 16, 32, 64) if b < n} | {n})
    return {f"{name} {b}": index(b) for b in blocks}


def _m14_check_logits(label: str, got, ref, plain_err: float) -> str:
    """The first step's logits at tp 2 against the meshless run: within
    QMM_TOL x max(1, |ref|) or, where the same pair of runs with every
    kernel replaced by its plain version on the card (_M14Plain) differs by
    more, within SPEC_TIE_FACTOR times that: the net's own drift under tp
    2's reordered bf16 sums, measured in the run, which must itself stay
    within TINY_LOGIT_TOL x max(1, |ref|), the limit of two bf16
    computations of a whole net (phases 4, 22, 26). -> the reading."""
    scale = max(1.0, float(ref.abs().max()))
    err = float((got - ref).abs().max())
    assert plain_err <= TINY_LOGIT_TOL * scale, f"{label}: with the plain versions, tp 2's " \
        f"first-step logits differ by {plain_err} > {TINY_LOGIT_TOL * scale}"
    tol = max(QMM_TOL * scale, SPEC_TIE_FACTOR * plain_err)
    assert err <= tol, f"{label}: first step's logits {err} > {tol} (the plain versions' " \
        f"tp drift {plain_err})"
    return (f"first step's logits max |err| {err:.4e} ({err / (QMM_TOL * scale):.2f} x QMM_TOL x "
            f"max(1, |ref|)); the same pair with the plain versions in the kernels' place "
            f"{plain_err:.4e} ({plain_err / (QMM_TOL * scale):.2f} x); limit {tol:.4e}")


def _m14_whisper_drift(params, local, config, tp_config, mel, tok) -> tuple[str, float]:
    """(b2)'s first step again, meshless and at tp 2: the residual stream's
    error at each layer_norm input (encoder blocks, then the first decode
    step's), and the first step's logit difference of the same pair with
    the plain versions in the kernels' place. -> (growth line, that
    difference)."""
    opts = DecodingOptions(sample_len=1, language="en")

    def first(p, c, stream=None):
        with contextlib.ExitStack() as stack:
            if stream is not None:
                stack.enter_context(stream)
            spy = stack.enter_context(_M14Spy())
            decode(p, mel, tok, c, opts)
        return spy.logits[0]

    with _M14Stream(tw, "layer_norm", config.n_audio_state) as ref_stream:
        first(params, config)
    stream = _M14Stream(tw, "layer_norm", config.n_audio_state, ref_stream.points)
    first(local, tp_config, stream)
    del ref_stream
    with _M14Plain():
        plain_err = float((first(local, tp_config) - first(params, config)).abs().max())
    n = config.n_audio_layer
    marks = {"encoder's first attention half": 1,
             **_m14_marks("encoder block", n, lambda b: 2 * b),
             **_m14_marks("step-1 decoder block", config.n_text_layer,
                          lambda b: 2 * n + 1 + 3 * b)}
    _m14_check_stem("(b2) encoder", stream.points)
    return (f"(b2) residual stream at tp 2 against meshless, max|err| / max(1, max|ref|): "
            f"{_m14_growth(stream.points, marks)}", plain_err)


def _m14_qwen_drift(params, local, config, tp_config, ids, dev) -> tuple[str, float]:
    """(b3)'s prefill again, meshless and at tp 2: the residual stream's
    error at each rms_norm input of the model's width, and the last
    position's logit difference of the same pair with the plain versions
    in the kernels' place. -> (growth line, that difference)."""
    def prefill(p, c):
        cache = qw.init_kv_cache(c, 1, len(ids) + 8, dev)
        return qw.decode_step(p, torch.tensor([ids], device=dev), 0, cache, c)[0][0, -1].float()

    with _M14Stream(qw, "rms_norm", config.hidden_size) as ref_stream:
        prefill(params, config)
    with _M14Stream(qw, "rms_norm", config.hidden_size, ref_stream.points) as stream:
        prefill(local, tp_config)
    del ref_stream
    with _M14Plain():
        plain_err = float((prefill(local, tp_config) - prefill(params, config)).abs().max())
    marks = {"first attention half": 1,
             **_m14_marks("layer", config.num_hidden_layers, lambda b: 2 * b)}
    _m14_check_stem("(b3)", stream.points)
    return (f"(b3) residual stream of the prefill at tp 2 against meshless, max|err| / max(1, "
            f"max|ref|): {_m14_growth(stream.points, marks)}", plain_err)


def _m14_tp_whisper(params, config, tok, dev, mesh, lines: list) -> dict:
    """(b2) tp 2 on large-v3: 2 windows of the 65 s file, M14_TP_STEPS greedy
    steps, K2 and K3 at 10 of the 20 heads a rank, beside the meshless run:
    the first step's logits (_m14_check_logits) and the tokens up to a first
    parting that is a near tie (SPEC_TIE_FACTOR x D, D the largest logit
    difference over the steps both runs take on the same tokens). -> the
    launches of the tensor-parallel decode."""
    from whisper_mlx_tpu_torch.parallel.sharding import shard_model

    audio = _request_audio(65.0, 0)
    with torch.inference_mode():
        mel_all = log_mel_spectrogram(F.pad(torch.from_numpy(audio).to(dev), (0, N_SAMPLES)),
                                      n_mels=config.n_mels)
        mel = mel_all[:6000].reshape(2, 3000, -1)
        opts = DecodingOptions(sample_len=M14_TP_STEPS, language="en")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _M14Spy() as ref_spy:
            ref = decode(params, mel, tok, config, opts)
        torch.cuda.synchronize()
        ref_wall = time.perf_counter() - t0
        local, tp_config = shard_model(params, config, mesh)
        heads = local["encoder"]["blocks"][0]["attn"]["q"]["w"].shape[0] // config.head_dim
        _m14_zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _M14Spy() as spy:
            got = decode(local, mel, tok, tp_config, opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _m14_counts()
        growth, plain_err = _m14_whisper_drift(params, local, config, tp_config, mel, tok)
    assert heads == config.n_audio_head // mesh.tp, heads
    lines.append(growth)
    d = max(_m14_d([x[w] for x in ref_spy.logits], [x[w] for x in spy.logits], a.tokens,
                   b.tokens) for w, (a, b) in enumerate(zip(ref, got)))
    lines.append(f"(b2) tp 2 large-v3: {heads} heads a rank, 2 windows, {M14_TP_STEPS} steps, "
                 f"wall {wall:.3f} s (meshless {ref_wall:.3f} s), launches {counts}; "
                 f"collectives a step (the second) "
                 f"{spy.collectives[1]}; "
                 f"{_m14_check_logits('(b2)', spy.logits[0], ref_spy.logits[0], plain_err)}; "
                 f"D {d:.4e}")
    for w, (a, b) in enumerate(zip(ref, got)):
        _spec_check(f"m14 (b2) window {w}", a.tokens, b.tokens,
                    lambda i, w=w, a=a, b=b: float(ref_spy.logits[i][w, a.tokens[i]]
                                                   - ref_spy.logits[i][w, b.tokens[i]]), d)
    return counts


def _m14_qwen_run(params, config, ids, dev):
    """Prefill of ``ids`` then M14_QWEN_STEPS greedy steps: -> (M14_QWEN_STEPS
    + 1 tokens, the logits predicting each, the collectives of one step)."""
    from whisper_mlx_tpu_torch.parallel import mesh as mesh_mod

    cache = qw.init_kv_cache(config, 1, len(ids) + M14_QWEN_STEPS + 8, dev)
    logits, _ = qw.decode_step(params, torch.tensor([ids], device=dev), 0, cache, config)
    out, toks = [logits[0, -1].float()], []
    for s in range(M14_QWEN_STEPS + 1):
        toks.append(int(out[-1].argmax()))
        if s == M14_QWEN_STEPS:
            break
        before = dict(mesh_mod.COUNTS)
        logits, _ = qw.decode_step(params, torch.tensor([[toks[-1]]], device=dev),
                                   len(ids) + s, cache, config)
        step = {k: mesh_mod.COUNTS[k] - before[k] for k in before}
        out.append(logits[0, -1].float())
    return toks, out, step


def _m14_tp_qwen(dev, mesh, lines: list) -> dict:
    """(b3) tp 2 at Qwen3-32B's widths, packed int4, M14_QWEN_LAYERS layers:
    the 270-token prompt's prefill (K4, 32 query heads over 4 KV heads a
    rank) and M14_QWEN_STEPS steps (K5 on column and row shards), at kv 0
    and kv 8 (K3's GQA mode), held as (b2) holds whisper. -> launches."""
    from whisper_mlx_tpu_torch.parallel.sharding_llm import shard_qwen_model

    base = dataclasses.replace(QWEN32, num_hidden_layers=M14_QWEN_LAYERS, dtype=torch.bfloat16,
                               flash_attention=True)
    params = qw.init_random_quant_params(base, seed=0, device=dev)
    ids = ByteFallbackTokenizer().encode(_prompt_text(np.random.default_rng(6), 270))
    totals: dict = {}
    local, tp_config = shard_qwen_model(params, base, mesh)
    with torch.inference_mode():
        growth, plain_err = _m14_qwen_drift(params, local, base, tp_config, ids, dev)
    lines.append(growth)
    del local
    for kv in (0, 8):
        config = dataclasses.replace(base, kv_bits=kv)
        local, tp_config = shard_qwen_model(params, config, mesh)
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref_toks, ref_logits, _ = _m14_qwen_run(params, config, ids, dev)
            torch.cuda.synchronize()
            ref_wall = time.perf_counter() - t0
            _m14_zero()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks, logits, step = _m14_qwen_run(local, tp_config, ids, dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _m14_counts()
        d = _m14_d(ref_logits, logits, ref_toks, toks)
        qkv = local["layers"][0]["attn"]["qkv"]["w"].shape
        lines.append(f"(b3) tp 2 Qwen3-32B int4 kv {kv}, {M14_QWEN_LAYERS} layers: qkv shard "
                     f"{qkv}, prefill {len(ids)} tokens + {M14_QWEN_STEPS} steps, wall "
                     f"{wall:.3f} s (meshless {ref_wall:.3f} s), launches {counts}; "
                     f"collectives a step {step}; "
                     f"{_m14_check_logits(f'(b3) kv {kv}', logits[0], ref_logits[0], plain_err)}; "
                     f"D {d:.4e}")
        _spec_check(f"m14 (b3) kv {kv}", ref_toks, toks,
                    lambda i: float(ref_logits[i][ref_toks[i]] - ref_logits[i][toks[i]]), d)
        _m14_add(totals, counts)
        del local
    return totals


def _m14_rank(rank: int, world: int, coordinator: str) -> dict:
    """One of phase 27's two ranks, both on cuda:0, in a gloo group: (b1),
    (b2) and (b3). -> its lines, launches and peak memory."""
    import torch.distributed as dist

    from whisper_mlx_tpu_torch.parallel.mesh import init_distributed, make_mesh

    import io

    dev = setup_device("cuda:0")
    init_distributed(coordinator, world, rank, backend="gloo", device=dev)
    printed = io.StringIO()  # _spec_check's lines, returned with the rank's own
    try:
        lines = [f"backend {dist.get_backend()}, {world} ranks on {torch.cuda.get_device_name(0)}"]
        devices = [dev] * world
        dp2, tp2 = make_mesh(dp=2, tp=1, devices=devices), make_mesh(dp=1, tp=2, devices=devices)
        base = WHISPER_CONFIGS["large-v3"]
        params, config = apply_asr_serving_config(
            init_params(base, seed=0, device=dev, dtype=torch.bfloat16), base, dev)
        tok = _wordy_tokenizer(config.n_vocab)
        torch.cuda.reset_peak_memory_stats()
        totals: dict = {}
        with contextlib.redirect_stdout(printed):
            _m14_add(totals, _m14_dp(rank, params, config, tok, dev, dp2, lines))
            _m14_add(totals, _m14_tp_whisper(params, config, tok, dev, tp2, lines))
            del params
            gc.collect()
            torch.cuda.empty_cache()
            _m14_add(totals, _m14_tp_qwen(dev, tp2, lines))
        return {"lines": lines + [ln.strip() for ln in printed.getvalue().splitlines()],
                "launches": totals, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    finally:
        dist.destroy_process_group()


def phase_m14() -> dict:
    """Phase 27: multi-device parallelism (ROADMAP M14). (a) in this process
    (_m14_world_of_one), then (b) two ranks sharing the card over gloo
    (_m14_rank through parallel/launch.py:run_ranks). -> the launches of
    K1-K5 and K3's GQA mode over the phase's main-path runs, summed over
    the ranks (the comparison runs left out)."""
    from whisper_mlx_tpu_torch.parallel.launch import run_ranks

    t_phase = time.perf_counter()
    totals: dict = {}
    _m14_shard_kernels()
    print(f"  m14 kernels at the tp-2 shard shapes: {time.perf_counter() - t_phase:.1f} s")
    _m14_world_of_one(totals)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks("chip_smoke.py:_m14_rank", 2, timeout_s=M14_RANKS_TIMEOUT_S)
    for r, out in enumerate(ranks):
        for line in out["lines"]:
            print(f"  m14 rank {r}: {line}")
        print(f"  m14 rank {r}: peak memory {out['peak_gib']:.2f} GiB, launches {out['launches']}")
        _m14_add(totals, out["launches"])
    print(f"  m14 (b) two ranks over gloo: {time.perf_counter() - t0:.1f} s with the ranks' "
          f"start; the phase {time.perf_counter() - t_phase:.1f} s")
    print(f"  launches over the phase's main-path runs, summed over ranks: {totals}")
    for key in ("mel", "dense", "decode", "flash", "quant", "gqa"):
        assert totals.get(key, 0) > 0, f"kernel {key} was not launched on phase 27's path"
    print(f"m14: {_smi()}")
    return totals


def _timed_phase(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s")
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one GPU")
    parser.add_argument("--only", default="", help="comma-separated phases to run after the "
                        "device and build phases (a partial run prints no result line and exits 2): "
                        "kernels, tiny, main, beam, llm_kernels, tiny_qwen, llm, "
                        "residency_kernels, residency, probe_kernels, probe_mains, tiny_quant, "
                        "quant_main, serve, spec, daemon, llm_kv, m15, m14, and batches, "
                        "residency_times, "
                        "beam_times, "
                        "beam_batches, tiled_times, a8_times and gqa_times, which run only "
                        "when named")
    only = [name for name in parser.parse_args(argv).only.split(",") if name]
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    rows, launches, on_4bit, serve, spec, daemon, kv, m15, m14 = ({}, {}, {}, {}, {}, {}, {},
                                                                  {}, {})

    def residency():
        out = {}
        for env in RESIDENCY:
            gc.collect()
            torch.cuda.empty_cache()
            out.update(_timed_phase(f"llm residency {env}", phase_llm_residency, env))
        return out

    # name -> (title, function, where its result goes)
    phases = {
        "kernels": ("kernels", phase_kernels, rows),
        "tiny": ("tiny", phase_tiny, None),
        "main": ("main path", phase_main_path, launches),
        "beam": ("beam main path", phase_beam_main_path, launches),
        "llm_kernels": ("llm kernels", phase_llm_kernels, rows),
        "tiny_qwen": ("tiny qwen", phase_tiny_qwen, None),
        "llm": ("llm main path", phase_llm_main_path, launches),
        "residency_kernels": ("llm residency kernels", phase_residency_kernels, rows),
        "residency": ("llm residency", residency, launches),
        "probe_kernels": ("probe kernels", phase_probe_kernels, rows),
        "probe_mains": ("probe entry points", phase_probe_mains, launches),
        "tiny_quant": ("tiny 4-bit whisper", phase_tiny_quant, None),
        "quant_main": ("whisper 4-bit main path", phase_quant_main_path, on_4bit),
        "serve": ("serve", phase_serve, serve),
        "spec": ("speculative decoding", phase_spec, spec),
        "daemon": ("daemon", phase_daemon, daemon),
        "llm_kv": ("llm kv cache", phase_llm_kv, kv),
        "m15": ("m15", phase_m15, m15),
        "m14": ("m14", phase_m14, m14),
        "batches": ("batches", phase_batches, None),
        "residency_times": ("llm residency times", phase_residency_times, None),
        "beam_times": ("beam kernel times", phase_beam_times, None),
        "beam_batches": ("beam batches", phase_beam_batches, None),
        "tiled_times": ("tiled times", phase_tiled_times, None),
        "a8_times": ("a8 and mel times", phase_a8_times, None),
        "gqa_times": ("gqa times", phase_gqa_times, None),
        "gqa_split": ("gqa split", phase_gqa_split, None),
    }
    only_named = ("batches", "residency_times", "beam_times", "beam_batches", "tiled_times",
                  "a8_times", "gqa_times", "gqa_split")
    unknown = [name for name in only if name not in phases]
    if unknown:
        parser.error(f"unknown phases {unknown}")
    _timed_phase("device", phase_device)
    _timed_phase("build", phase_build)
    for name, (title, fn, sink) in phases.items():
        if name not in only and (only or name in only_named):
            continue
        gc.collect()
        torch.cuda.empty_cache()
        out = _timed_phase(title, fn)
        if sink is not None:
            sink.update(out)
    if only:
        print(f"partial run ({', '.join(only)}): no result line, exit code 2")
        return 2
    launches["dense_fast"] = on_4bit["dense_fast"]
    # the tiled launches (phase 9's prefills for K5, phase 11's for K6 and K7)
    tiled = {key: launches.pop(f"{key}_tiled") for key in ("quant", "mbt", "a8")}
    kernels = []
    for key, mod_launches in launches.items():
        row = dict(rows[key])
        row["launches"] = mod_launches
        if key in tiled:
            row["launches_tiled"] = tiled[key]
        if key in ("mel", "dense", "decode", "quant", "mbt"):
            row["launches_4bit"] = on_4bit[key]
        if key in ("mel", "dense", "decode"):  # the serving path (phase 22)
            row["launches_serve"] = serve[f"{key}_serve"]
        if key in spec["launches"]:  # the speculative runs (phase 23)
            row["launches_spec"] = spec["launches"][key]
        if f"{key}_daemon" in daemon:  # the HTTP daemon's requests (phase 24)
            row["launches_daemon"] = daemon[f"{key}_daemon"]
        if f"{key}_kv" in kv:  # the quantized-cache path (phase 25)
            row["launches_kv"] = kv[f"{key}_kv"]
        if key in m15["launches"]:  # the last opt-ins' path (phase 26)
            row["launches_m15"] = m15["launches"][key]
        if key in m14:  # the sharded paths, summed over the ranks (phase 27)
            row["launches_m14"] = m14[key]
        if key == "decode":  # K3's GQA mode on phase 27's tensor-parallel Qwen
            row["launches_gqa_m14"] = m14["gqa"]
        if key == "beamflat":  # its split and per-lane modes (phase 26)
            row.update(m15["rows"], launches_split_m15=m15["launches"]["beamflat_split"],
                       launches_lane_m15=m15["launches"]["beamflat_lane"])
        if key == "decode":  # K3's GQA mode: phase 7's times, phase 25's launches
            row.update(rows["gqa"], launches_gqa=kv["gqa_kv"])
        if key == "decode":  # the verify's shape: one window, Tq = 5, pos 226, self + cross
            ms, bound = spec["times"]["k3_tq5"]
            row.update(ms_verify=ms, bound_verify_ms=bound["bound_ms"],
                       bound_verify_by=bound["bound_by"],
                       ms_1row_1window=spec["times"]["k3_tq1"][0])
        if key == "quant":  # Qwen3-32B's five linears at the verify's M = 5, beside M = 1
            ms, bound = spec["times"]["k5_m5"]
            row.update(ms_m5=ms, bound_m5_ms=bound["bound_ms"], bound_m5_by=bound["bound_by"],
                       ms_m1_layer0=spec["times"]["k5_m1"][0])
        if key in ("quant", "mbt"):  # at the large-v3 shapes, beside the Qwen3-32B ones
            row["max_abs_err_4bit"] = on_4bit[f"{key}_err"]
        if key == "quant":  # a large-v3 decode step's K5 calls at 8 rows, L2 cold
            row["ms_4bit_step_8rows"] = on_4bit["quant_step_8rows_ms"]
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
