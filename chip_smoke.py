#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            # everything, as a check of the port
    python3 chip_smoke.py --profile  # where a decode step's time goes
                                     # (bf16, then int8 KV + weights),
                                     # bursts read back serially and
                                     # pipelined; then 8 structured rows:
                                     # the mask term's device time
    python3 chip_smoke.py --tp-cards # on a host of 2-4 cards: tensor
                                     # parallelism with a card a rank
                                     # (NCCL), see tp_cards_phase, then
                                     # the --pp-cards runs
    python3 chip_smoke.py --pp-cards # a card a stage: pp_cards_phase
    python3 chip_smoke.py --pp-70b   # only its Llama-3-70B pp 4 run
    python3 chip_smoke.py --kv-ranks # only phase 19 (kv_ranks_phase)

Phases, each of which fails the run (non-zero exit, no result line):

1. build the three kernel libraries from ``production_stack_tpu_torch/csrc``
   (both attention kernels and the page probes; one nvcc per source,
   started together), print the compiler's register/shared-memory
   report to standard error and a ``{"sass": ...}`` line of each kernel
   instantiation's tensor-core and asynchronous-copy instructions
   (``cuobjdump -sass``): a bf16 instantiation of either attention
   kernel or of the strided probe without both fails the run (the
   probe's ``reads`` takes no products: asynchronous copies only);
2. hold the port's threefry (``engine/prng.py``: key data, bits and
   categorical draws) on the card to golden values that JAX computed
   (``GOLDEN``, written by ``tests/test_torch_prng.py``), bit for bit
   (a ``{"threefry": ...}`` line);
3. hold each attention kernel, in both page encodings (pages in q's
   dtype, and int8 pages with float32 scales), against its plain PyTorch
   version on the same CUDA tensors, at the Llama-3-8B main-path shapes
   in bf16 (the cached prefill also as the engine's batched prefill of a
   storm: 4 rows at the 1,024 bucket, one of them padding) and at small
   shapes in f32 (the kernels' check mode) and in bf16, and time kernel,
   plain version and a library yardstick (``scaled_dot_product_attention``
   on pre-gathered contiguous K/V, dequantized beforehand for int8, which
   excludes the page gather and the dequant and is never called by the
   port); the batched case is timed beside the single row (a
   ``{"batched_prefill": ...}`` line);
4. the page probes of the decode kernel (``csrc/page_probes.cu``: the
   page gather alone, and with per-head reads or with both products and
   no softmax), each mode and page dtype against its plain version at
   small shapes, at the 8B decode case and at the JAX scripts' shapes;
   then the probe path driven through its entry points (the
   ``torch.sum`` yardstick, the gather, reads and products at 4-64 pages
   a block and at the decode kernel's own split, and the decode kernel on
   the same pools, its time split by the probes at that split:
   ``decode_decomposition``), every rate held under 1.05 x 3.35 TB/s,
   printed as a ``{"probes": ...}`` line;
5. serve ``meta-llama/Llama-3-8B`` at full width and depth with random
   weights through the port's OpenAI server (in-process, on a thread)
   under the JAX engine's default step (prefill batching at 4 rows, the
   step recorder, pipelined decode bursts) and drive it over HTTP:
   concurrent greedy completions, a chunked long prompt, a prefix-cache
   hit, a streamed sampled chat, a repeated greedy request, a storm of
   six ~2,000-token prompts (batched prefills), a seeded sampled request
   sent twice (one text), ``/debug/steps`` and a ``/metrics`` scrape;
   every request must finish with ``stop`` or ``length``, both kernels
   must have launched and a batched prefill must have run (a
   ``{"recorder": ...}`` line: step kinds, ``tpu:step_*`` series, the
   bandwidth share against 3.35e12 B/s);
6. free that engine and serve the same model again with
   ``--kv-cache-dtype int8 --quantization int8`` (int8 KV pages, int8
   weights), driven the same way; both kernels must have launched in
   their int8 mode, and never in the other. No probe launches on either
   served path;
7. serve bf16 again with chunked-prefill step plans
   (``--enable-chunked-prefill --max-num-batched-tokens 512``, ten
   slots): eight short prompts arrive together (a step plan's rows must
   go as one batched dispatch), then two ~2,000-token prompts together, which
   prefill in 512-token steps between the eight's decode bursts; then
   three shorts and a long one at a time (a ``{"chunked": ...}`` line);
   then its twin with ``--fused-step`` (:func:`fused_phase`): each step
   plan and the decode burst launched as ONE dispatch while sequences
   run, the one-at-a-time segment's greedy texts equal to the chunked
   run's (the concurrent segment's equal texts counted), fused steps
   taken and
   recorded as such, every dispatch of both runs accounted for by their
   step records (a fused step one; a plan and a burst one each), both
   kernels launched, the fused step's wall time beside an alternating
   plan's plus burst's (a ``{"fused": ...}`` line); then Whisper
   (:func:`asr_phase`): whisper-small at full width (d 768, 12 + 12
   layers, vocab 51,865; random bf16 weights from seed 0) behind the
   port's ASR server, a 30 s and a 5 s WAV in the three response
   formats, the 400 cases and a 413, ``/metrics`` counting them; float32
   on the card against the host on the same weights (encoder states and
   logits within ``ASR_F32_TOL``, which a TF32 run of the card must
   fail; 16 greedy tokens equal); a checkpoint
   of the served weights through the port's writer and loader, bit for
   bit; the mel frontend's, the encoder's and a token's times beside the
   encoder's operation bound and a token's byte bound (an ``{"asr":
   ...}`` line);
8. speculative decoding at full width and ``SPEC_LAYERS`` = 8 of 32
   layers (a local directory holding the config.json): the same eight
   greedy 128-token requests (four prompts repeating a phrase, four of
   ``_text``) and a seeded sampled pair served by Llama-3-8B in bf16
   plain, with ``--speculative-num-tokens 4`` (prompt lookup), and
   drafting for itself (``--speculative-draft-model`` that directory), a
   ``{"spec": ...}`` line a run (verify bursts, acceptance, tokens per
   target forward against the plain run, launches, the recorder's
   ``spec_verify`` steps, the ``tpu:spec_*`` scrape); a speculative run
   fails without a verify burst, the self-drafter below 0.5 acceptance,
   and any run on an errored request or a seeded pair of two texts. The
   kernel phase holds the verify's shape (8 rows x 4 tokens over
   2,048-token contexts, both page encodings) to the plain version and
   times it beside SDPA (a ``{"verify_prefill": ...}`` line);
9. tiny-llama and tpu-llama-1b at float32 on the card (the kernels' f32
   mode): streams of both proposers, greedy, through preemption, seeded
   sampled and under grammars, equal to plain decode's token for token,
   the greedy self-drafter accepting every draft under a grammar (a
   ``{"spec_parity": ...}`` line);
10. structured output at full width (before the speculative phases):
   Llama-3-8B at ``STRUCTURED_LAYERS`` = 8 of its 32 layers (cut to pay
   for the fused and asr phases) in bf16, then with ``--kv-cache-dtype
   int8 --quantization int8``, eight requests at once (a corpus
   ``guided_json`` schema, a ``response_format`` ``json_schema``,
   ``guided_regex`` ``[ab]{3}``, an enum schema on a ~2,000-token
   prompt, a grammar on a prompt that hits the prefix cache, three
   unconstrained rows, two of them ~2,000-token prompts): a finite
   language's text must fullmatch its grammar, an open one's keep its
   automaton alive, and ``structured_violations_total``
   must move by the length caps mid-structure only; a plain and a
   structured request alone give the decode forwards a token costs each;
   the mask's host seconds a state at the 128,256-token vocabulary and
   its device time (``mask_costs``); in bf16 also a seeded ``n = 4``
   completion (choice ``i`` equal to a single request under seed ``base
   + i``, its streamed form carrying every index) and a chat with
   ``tools`` (a ``{"structured": ...}`` line a run). The speculative runs
   of phase 8 end with two grammar requests (the self-drafter's take
   FSM-constrained draft steps: its ``[8, 32]`` rows with one live token
   a row run the cached-prefill kernel, which the kernel phase holds to
   the plain version at that shape over 2,048-token contexts, timed
   beside the decode kernel, a ``{"draft_step_prefill": ...}`` line).

11. KV movement at full width and ``KV_LAYERS`` = 8 of 32 layers (cut
   to pay for the fused and asr phases; after the speculative phases),
   in bf16 and with ``--kv-cache-dtype int8 --quantization int8``, each
   engine's pool bounded to 96 blocks (:func:`kv_phase`):
   a 2,048-token prompt evicted to the host tier and restored (its
   stream equal to its prefix-hit stream, at least 31 blocks restored,
   the cached-prefill kernel run), ``/kv/pull`` between two engines
   behind their servers over the host relay and the local-device rung,
   a prompt spilled to a stdlib L3 block store by one engine and
   restored from it by the other, ``/kv/prepare_pull`` answering with
   an offer of the prefix's pages (the KV device pipe, phase 19);
   spill, restore and card-to-card times and the prefix hashes' host
   cost (a ``{"kv": ...}`` line each).
12. facebook/opt-125m at full width and depth (12 layers, hidden 768,
   12 heads of 64: a head group of one, vocab 50,272, 2,048-token
   contexts) through the port's server, in bf16 pages and with
   ``--kv-cache-dtype int8``, driven as phase 5 drives Llama-3-8B (a
   1,900-token prompt in 1,024-token chunks); both kernels must launch
   in the configured page mode; the decode step's host and device time
   (an ``{"opt": ...}`` line each). The kernel phase holds both kernels
   to their plain versions at OPT-125m's shapes (decode 8 x 2,048 and
   ragged, cached prefill 1,024 over 1,024, the second chunk of a
   1,901-token prompt, a storm's batched prefill), in both page
   encodings, and times decode and cached prefill beside their bounds
   and SDPA (their rows join the kernels line as ``*_opt``);
13. Mixtral-8x7B at full width, bf16, cut to ``MIXTRAL_LAYERS`` = 24 of
   its 32 layers (70.2 GB of weights; all 32 are 92.9 GB), named by a
   local directory holding its config.json, driven as phase 5; the
   decode step's host and device time, the dense MoE's share of the
   device time, weight bytes and peak ``memory_allocated`` (a
   ``{"mixtral": ...}`` line);
14. Llama-3-8B bf16: LoRA adapters loaded by name (the JAX engine's:
   zero B, the base stream) and with explicit weights (another stream),
   listed, metered, unloaded; ``/v1/embeddings``, ``/v1/score`` and
   ``/v1/rerank``; ``/sleep`` (device memory falls by the weights plus
   the pool) and ``/wake_up`` (the stream before equals the stream
   after), timed; ``/drain`` (a ``{"lifecycle": ...}`` line);
15. local checkpoints (before phase 16; :func:`checkpoint_phase`):
   Llama-3-8B at full width cut to ``CKPT_LAYERS`` = 4 of its 32 layers
   (3.85 GB of bf16 weights drawn from a seed), written with the port's
   standard-library safetensors writer under HF names with a config.json
   and served from the directory behind an API key, in bf16 and with
   ``--kv-cache-dtype int8 --quantization int8``: every leaf on the card
   bit for bit (under int8, ``quantize_loaded`` of the written tree), a
   bare request 401, both kernels launched, greedy texts equal to an
   engine handed the same tensors, a 1 s ``/debug/profile`` artifact,
   ``/debug/traces`` with stage times that add up, an echoed
   ``X-Request-Id``; OPT-125m from a ``pytorch_model.bin``, bit for bit;
   a tiny draft directory whose speculative streams equal plain decode's
   (a ``{"checkpoint": ...}`` line: write, read and load times, the read
   rate, device bytes);
16. tiny-opt and tiny-mixtral at float32 on the card, token-identical
   to the same engines on the CPU through chunks, preemption and a
   prefix hit (an ``{"arch_parity": ...}`` line).
17. tensor parallelism (:func:`tp_phase`), every rank a process of its
   own on the one card under gloo, each started by the port's server
   entry (``--tensor-parallel-size``): Llama-3-8B at full width and
   ``TP_LLAMA_LAYERS`` = 4 of its 32 layers, bf16, at tp 2 (decode bursts, a 2,500-token prompt's chunks, a
   prefix hit, a seeded pair; then a decode step's host time, the
   leader's device time and the collectives' share); tpu-llama-1b in
   float32 at tp 1, 2 and 4, token-identical streams; Mixtral-8x7B at
   full width and 4 layers at tp 2 (4 experts a rank); OPT-125m at tp 2
   and 4. Both kernels must launch on every rank at its heads, and no
   rank may run on the CPU (a ``{"tp": ...}`` line: each rank's device,
   weight bytes, pool blocks and launches by shape). The kernel phase
   holds both kernels at each rank's heads (Llama-3-8B at tp 2, 4 and 8:
   KVH 4, 2 and 1; OPT-125m at 6 and 3 heads) to their plain versions
   and times them (``*_tp*`` rows of the kernels line, launches counted
   by shape over the ranks of the tp phase).
18. pipeline and data parallelism (:func:`pp_phase`), every rank a
   process on the one card under gloo (activations staged through
   pinned host memory): Llama-3-8B at full width and ``PP_LLAMA_LAYERS``
   = 4 of its 32 layers, bf16, at ``--pipeline-parallel-size 2`` (2
   layers a stage, both kernels on both stages at 32/8 heads, 2 decode
   launches a stage a microbatch; then the decode profile: host ms a
   step, each stage's device busy, the transfers a step and their
   share); tpu-llama-1b in float32 at pp 2, pp 4 (one microbatch and
   the default), pp 2 x tp 2 and dp 2, each token-identical to phase
   17's tp 1 streams; ``pipeline_forward`` and ring attention on 2 ranks
   against their plain versions, and what one transfer costs alone (a
   ``{"pp": ...}`` line). The pp stages' launches join the main rows of
   the kernels line (the same 32/8-head shape). The spec phases (8) run
   Llama-3-8B's widths at ``SPEC_LAYERS`` = 8 of its 32 layers.
19. KV movement and the lifecycle across ranks, and the KV device pipe
   (:func:`kv_ranks_phase`): Llama-3-8B at full width and 4 layers, bf16,
   at tp 2 (both ranks on the card under gloo) beside a tp 1 engine of
   the same weights: a 2,048-token prefix (32 blocks, 64 MiB) extracted
   at tp 2 and injected at tp 1, and the reverse, each moved back out
   bit for bit and serving that engine's own prefix-hit stream; spilled
   to every rank's host store (the same hashes on every rank) and
   restored; sleep (bytes freed by each rank) and wake (seconds); both
   kernels at a rank's 16/4 heads on both ranks. Two server processes on
   the card: ``kv_path: "device"`` moves the prefix through the KV
   device pipe (CUDA IPC), against the host relay (bytes, seconds, GB/s
   beside the 0.040 ms bound of its read and write, first-token times;
   equal streams). tpu-llama-1b float32 at pp 2 (the payload bit-equal
   to tp 1's) and pp 2 x tp 2 with int8 pages (codes within one of tp
   1's). A ``{"kv_ranks": ...}`` line; the tp 2 ranks' launches join
   the ``*_tp2`` rows of the kernels line, the tp 1 engine's the main
   rows.

The output ends with a ``{"kernels": [...]}`` line (each kernel in each
page encoding, the cached prefill also at the verify's and the
FSM-constrained draft step's shapes, both attention kernels also at
OPT-125m's shapes, each probe in each mode and page dtype), the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
It imports nothing of JAX and nothing of the JAX package, and exits
non-zero without a CUDA device or outside a checkout of the repo.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import os
import re
import shutil
import subprocess
import sys
import time

# Tolerances of kernel vs plain version, elementwise.
# f32: 2e-3 absolute, the TPU kernels' own parity bar; the f32 cases have
# short contexts, where |o| is 0.1-1 and a lost key tile moves o by O(0.1).
# bf16: per output row (one query token, one head), 2^-5 of the row's
# largest |o|, i.e. four to eight bf16 ulps of that element. Both sides
# round an f32 result to bf16 (at most 1/2 ulp each, so one ulp of the
# row's largest element apart), and the plain version's bf16 P.V product
# may reduce partial sums in bf16 (about one ulp more); two ulps are
# 2^-6 of the row's largest |o| at most, and were measured in the
# prefill cases. The rest is far below an ulp: the plain version rounds
# its softmax probabilities to bf16 (2^-9 relative per term, random in
# sign: ~1e-5 on o at 2k keys) and the kernel takes q pre-scaled and
# rounded to bf16 (~1e-3 on a score, ~1e-5 on o). A bar on the output's
# own scale matters because |o| is small here: with randn q/K/V over 2k
# keys o has a std of ~0.04. With int8 pages the kernel dequantizes into
# f32 while the plain version rounds each dequantized K/V element to bf16
# (2^-9 relative, random in sign) before its products: on o that is
# ~2^-9 x |v| x sqrt(sum p^2) ~ 2e-3 x 0.04 ~ 1e-4 from V and as much
# through the scores from K, about 2% of a bar of ~5e-3 (2^-5 of a row
# maximum near 0.15), so the same bar holds for both encodings.
# scripts/torch_kernel_faults.py shows that planted faults (a key tile
# skipped, a rescale left out; for int8 a scale read from kv head 0 or
# left out) fail this bar at the main-path shapes.
BF16_ROW_BAR = 2.0 ** -5
F32_BAR = 2e-3


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        "nvidia-smi: " + out.stderr.strip())


# -- compiled code ------------------------------------------------------------

# Tensor-core and asynchronous-copy instructions in the SASS of a kernel
# (mma.sync / wgmma; cp.async / TMA loads).
SASS_OPS = ("HMMA", "HGMMA", "LDGSTS", "UTMALDG")
# The bf16 (q) instantiations of both attention kernels and of the
# strided page probe, by name stem.
MMA_KERNELS = ("paged_decode_mma_kernel", "prefill_mma_kernel",
               "strided_probe_mma_kernel")


def _cuda_tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", name)
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found on PATH or in $CUDA_HOME/bin")
    return path


# Template arguments of the kernels' mangled names: page type, the probe's
# mode (a bool: dots), head dim.
_MANGLED = re.compile(
    r"((?:paged_decode|prefill|strided_probe)_(?:mma|f32)_kernel)"
    r"I(13__nv_bfloat16|a|f)(?:Lb([01])E)?Li(\d+)EE")
_PAGE_TYPES = {"13__nv_bfloat16": "bf16", "a": "int8", "f": "f32"}


def _short_name(mangled: str) -> str:
    """``kernel<pages, D>`` (the strided probe: ``kernel<pages, mode,
    D>``) of a kernel's mangled name (the name itself if it is not one of
    those kernels' instantiations)."""
    m = _MANGLED.search(mangled)
    if not m:
        return mangled
    mode = "" if m.group(3) is None else (
        "dots, " if m.group(3) == "1" else "reads, ")
    return (f"{m.group(1)}<{_PAGE_TYPES[m.group(2)]} pages, {mode}"
            f"D={m.group(4)}>")


def sass_counts(paths):
    """Per kernel library and kernel instantiation, the count of each of
    ``SASS_OPS`` in ``cuobjdump -sass`` of the built library. Raises if a
    bf16 instantiation of either attention kernel or of the strided probe
    has no asynchronous-copy (LDGSTS, UTMALDG) instruction, or no
    tensor-core one (HMMA, HGMMA) where it takes products (all but the
    probe's reads)."""
    op = re.compile(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z0-9]+)")
    out = {}
    for lib, path in paths.items():
        text = subprocess.run([_cuda_tool("cuobjdump"), "-sass", path],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        funcs = {}
        name = None
        for line in text.splitlines():
            head = re.match(r"\s*Function : (\S+)", line)
            if head:
                name = head.group(1)
                funcs[name] = dict.fromkeys(SASS_OPS, 0)
                continue
            m = op.search(line) if name else None
            if m and m.group(1) in SASS_OPS:
                funcs[name][m.group(1)] += 1
        out[lib] = {_short_name(k): n for k, n in funcs.items()}
    for lib, funcs in out.items():
        for name, n in funcs.items():
            if not any(k in name for k in MMA_KERNELS):
                continue
            products = n["HMMA"] + n["HGMMA"] > 0 or ", reads," in name
            if not products or n["LDGSTS"] + n["UTMALDG"] == 0:
                raise AssertionError(
                    f"{lib}: {name} has no tensor-core or no asynchronous-"
                    f"copy instruction: {n}")
    return out


# -- threefry on the card -----------------------------------------------------

# Golden values of the port's keyed draw, computed on the CPU by JAX
# (tests/test_torch_prng.py::golden writes them and checks them against
# this file): key data of make_rng_keys(0, 3, GOLDEN_SEEDS), the first 8
# 32-bit words of each key's bits, and jax.random.categorical of each key
# over the rows of golden_logits. The card's tensor-op threefry must give
# them bit for bit.
GOLDEN_SEEDS = (0, 7, 2**31 + 9, 2**33 + 5, -1, 123456789)
GOLDEN = {
    "keys": [[3223668805, 2222728495], [3722243546, 2605438598],
             [1329879705, 2803758931], [1244721678, 2594860169],
             [4196246994, 2395176892], [1209682192, 2454425494]],
    "bits": [[4096103414, 3209468632, 1800361510, 3437501324, 3997350603,
              4163326404, 3366530964, 318401958],
             [1093064685, 340245451, 1565252539, 389234795, 1891130269,
              2047988702, 3696102545, 4071142475],
             [3644338829, 3935543667, 758793332, 1669268916, 3890846687,
              1409047385, 3122422396, 1575780641],
             [2147908501, 3885424548, 472692237, 3892122656, 1962420968,
              4250648318, 2281264002, 2530049429],
             [4122913618, 3448078844, 3447197624, 73583405, 2475189623,
              3644278014, 1310597635, 2705665802],
             [3634326767, 3670461195, 2900356360, 1362545154, 2353349308,
              1551888889, 499497160, 400770793]],
    "draws": [47, 25, 32, 27, 56, 18],
}


def golden_logits(n: int):
    """[n, 64] float32 rows from numpy seed 0, a third of them masked."""
    import numpy as np

    rng = np.random.default_rng(0)
    logits = rng.normal(size=(n, 64)).astype(np.float32) * 2.0
    logits[rng.random((n, 64)) < 0.3] = -np.inf
    logits[:, 0] = np.maximum(logits[:, 0], 0.0)
    return logits


def threefry_check(device: str = "cuda") -> dict:
    """The port's key data, bits and categorical draws of the golden
    inputs, computed on ``device``."""
    import torch

    from production_stack_tpu_torch.engine import prng

    seeds = torch.tensor(GOLDEN_SEEDS, dtype=torch.int64, device=device)
    keys = prng.make_rng_keys(0, 3, seeds)
    logits = torch.from_numpy(golden_logits(len(GOLDEN_SEEDS))).to(device)
    return {"keys": keys.cpu().tolist(),
            "bits": prng.random_bits(keys, 8).cpu().tolist(),
            "draws": prng.categorical(keys, logits).cpu().tolist()}


# -- kernel phase -----------------------------------------------------------

def _tables(rng, B, MAXB, NB):
    """Distinct shuffled pages per sequence (scattered like real tables)."""
    import numpy as np

    return rng.permutation(NB)[: B * MAXB].reshape(B, MAXB).astype(np.int32)


def _pages(g, dtype, shape, int8):
    """Random pages [L, NB, bs, KVH, D] in ``dtype``, or those values
    quantized into the int8 ``(data, scales)`` encoding."""
    import torch

    from production_stack_tpu_torch.ops.attention import quantize_kv

    x = torch.randn(shape, generator=g, device="cuda", dtype=dtype)
    if not int8:
        return x
    data, scales = quantize_kv(x)
    return data, scales.reshape(shape[0], shape[1], shape[2] * shape[3])


def decode_case(dtype, B, H, KVH, D, L, bs, MAXB, ctx, seed, int8=False):
    """Inputs of one decode-attention launch, made on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    NB = B * MAXB + 3
    k = _pages(g, dtype, (L, NB, bs, KVH, D), int8)
    v = _pages(g, dtype, (L, NB, bs, KVH, D), int8)
    q = torch.randn((B, H, D), generator=g, device="cuda", dtype=dtype)
    bt = torch.from_numpy(_tables(rng, B, MAXB, NB)).cuda()
    # Table entries past each live range point at page 0: a real page the
    # kernel must never read for this row.
    for b in range(B):
        bt[b, -(-ctx[b] // bs):] = 0
    cl = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    return dict(q=q, k_pages=k, v_pages=v, block_tables=bt, context_lens=cl,
                layer=L - 1, scale=D ** -0.5)


def prefill_case(dtype, B, T, H, KVH, D, L, bs, MAXB, prefix, take, seed,
                 int8=False):
    """Inputs of one cached-prefill launch in the engine's layout: the
    chunk's fresh K/V are already scattered (for int8 pages: quantized)
    into the pages, where the kernel and the plain version both read
    them."""
    import numpy as np
    import torch

    from production_stack_tpu_torch.ops.attention import write_kv_pages

    rng = np.random.default_rng(seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    NB = B * MAXB + 3
    k = _pages(g, dtype, (L, NB, bs, KVH, D), int8)
    v = _pages(g, dtype, (L, NB, bs, KVH, D), int8)
    q = torch.randn((B, T, H, D), generator=g, device="cuda", dtype=dtype)
    k_new = torch.randn((B, T, KVH, D), generator=g, device="cuda",
                        dtype=dtype)
    v_new = torch.randn((B, T, KVH, D), generator=g, device="cuda",
                        dtype=dtype)
    tables = _tables(rng, B, MAXB, NB)
    prefix = np.asarray(prefix, np.int64)
    take = np.asarray(take, np.int64)
    positions = prefix[:, None] + np.arange(T)[None, :]
    slots = np.full((B, T), -1, np.int64)
    for b in range(B):
        pos = positions[b, : take[b]]
        slots[b, : take[b]] = tables[b, pos // bs] * bs + pos % bs
    write_kv_pages(k, v, k_new, v_new, torch.from_numpy(slots), L - 1)
    bt = torch.from_numpy(tables).cuda()
    for b in range(B):
        bt[b, -(-int(prefix[b] + take[b]) // bs):] = 0
    return dict(
        q=q, k_pages=k, v_pages=v, block_tables=bt,
        positions=torch.from_numpy(positions).cuda(),
        total_lens=torch.tensor(prefix + take, dtype=torch.int32,
                                device="cuda"),
        layer=L - 1, scale=D ** -0.5)


# The engine's batched cached prefill (``core.py::_prefill_rows``) at the
# 1,024 chunk bucket: two first-round rows with an empty prefix, one over a
# 1,024-token prefix and a padding row; real query tokens of each row.
BATCHED_PREFIX = [0, 0, 1024, 0]
BATCHED_TAKE = [1024, 700, 1024, 0]


def batched_prefill_case(int8: bool, seed: int, H=32, KVH=8, D=128):
    """Inputs of one batched cached-prefill launch at the Llama-3-8B heads
    (or ``H``/``KVH``/``D``), the last row padding as the engine builds
    it: positions 0, total length 1, an all-zero table, no page
    writes."""
    import torch

    c = prefill_case(torch.bfloat16, 4, 1024, H, KVH, D, 2, 64, 32,
                     BATCHED_PREFIX, BATCHED_TAKE, seed=seed, int8=int8)
    c["positions"][3] = 0
    c["total_lens"][3] = 1
    c["block_tables"][3] = 0
    return c


def run_decode(c):
    from production_stack_tpu_torch.ops.paged_attention import paged_attention

    return paged_attention(c["q"], c["k_pages"], c["v_pages"],
                           c["block_tables"], c["context_lens"], c["layer"],
                           scale=c["scale"])


def plain_decode(c):
    from production_stack_tpu_torch.ops.attention import (
        paged_attention_reference,
    )

    return paged_attention_reference(
        c["q"], c["k_pages"], c["v_pages"], c["block_tables"],
        c["context_lens"], c["layer"], scale=c["scale"])


def run_prefill(c):
    from production_stack_tpu_torch.ops.prefill_attention import (
        cached_prefill_attention,
    )

    return cached_prefill_attention(
        c["q"], c["k_pages"], c["v_pages"], c["block_tables"],
        c["positions"], c["total_lens"], c["layer"], scale=c["scale"])


def plain_prefill(c):
    from production_stack_tpu_torch.ops.attention import (
        _context_prefill_reference,
    )

    return _context_prefill_reference(
        c["q"], c["k_pages"], c["v_pages"], c["block_tables"],
        c["positions"], c["total_lens"], c["layer"], scale=c["scale"])


# kernel entry (a kernel in one page encoding) -> (its wrapper, its plain
# version), each taking a case dict; the wrappers read the encoding off
# the pages.
KERNELS = {"paged_attention": (run_decode, plain_decode),
           "cached_prefill_attention": (run_prefill, plain_prefill),
           "paged_attention_int8": (run_decode, plain_decode),
           "cached_prefill_attention_int8": (run_prefill, plain_prefill),
           "cached_prefill_attention_verify": (run_prefill, plain_prefill),
           "cached_prefill_attention_verify_int8": (run_prefill,
                                                    plain_prefill),
           "cached_prefill_attention_draft_step": (run_prefill,
                                                   plain_prefill),
           "cached_prefill_attention_draft_step_int8": (run_prefill,
                                                        plain_prefill),
           "paged_attention_opt": (run_decode, plain_decode),
           "paged_attention_opt_int8": (run_decode, plain_decode),
           "cached_prefill_attention_opt": (run_prefill, plain_prefill),
           "cached_prefill_attention_opt_int8": (run_prefill,
                                                 plain_prefill)}

# facebook/opt-125m's attention: 12 heads of 64, multi-head (a head group
# of one), 2,048-token contexts.
OPT_HEADS = dict(H=12, KVH=12, D=64)

# The speculative verify (``core.py::_launch_verify``) at
# --speculative-num-tokens 4: every slot's last token and three drafts,
# [8, 4] query rows at the end of 2,048-token contexts.
VERIFY_K = 4
# The drafter's FSM-constrained draft step (``core.py::_draft_constrained``):
# [8, W0] rows at the smallest prefill bucket (EngineConfig's
# min_prefill_bucket), one live token a row in column 0 at the end of its
# context, the positions ascending over the whole row.
DRAFT_STEP_W0 = 32


def main_path_cases():
    """The Llama-3-8B cases of both kernels (32/8 heads, D 128, 64-token
    pages, bf16 q), over bf16 pages and over int8 pages: (label, kernel
    entry, inputs, output rows compared)."""
    import torch

    bf16 = torch.bfloat16
    B, H, KVH, D, bs, ctx_len = 8, 32, 8, 128, 64, 2048
    ragged = [2048, 1, 37, 2000, 1500, 64, 65, 1024]
    cases = []
    for enc, seed in (("bf16", 0), ("int8", 100)):
        int8 = enc == "int8"
        suffix = "_int8" if int8 else ""
        cases += [
            (f"paged_attention {enc} ragged", "paged_attention" + suffix,
             decode_case(bf16, B, H, KVH, D, 2, bs, ctx_len // bs, ragged,
                         seed=seed + 10, int8=int8), None),
            (f"paged_attention {enc} 8x2048", "paged_attention" + suffix,
             decode_case(bf16, B, H, KVH, D, 2, bs, ctx_len // bs,
                         [ctx_len] * B, seed=seed + 11, int8=int8), None),
            # The third chunk of a 2,500-token prompt: 452 fresh tokens
            # padded to the 1024 bucket over a 2048-token prefix, table
            # capped at 64 pages; the padded query rows are discarded by
            # the engine.
            (f"cached_prefill {enc} ragged chunk",
             "cached_prefill_attention" + suffix,
             prefill_case(bf16, 1, 1024, H, KVH, D, 2, bs, 64, [2048], [452],
                          seed=seed + 30, int8=int8),
             (slice(None), slice(0, 452))),
            # A full 1024-token chunk continuation over a 1024-token prefix.
            (f"cached_prefill {enc} 1024/1024",
             "cached_prefill_attention" + suffix,
             prefill_case(bf16, 1, 1024, H, KVH, D, 2, bs, 32, [1024],
                          [1024], seed=seed + 31, int8=int8), None),
            # A batched prefill of a storm: each live row's real tokens.
            (f"cached_prefill {enc} batched 4x1024",
             "cached_prefill_attention" + suffix,
             batched_prefill_case(int8, seed + 32),
             [(b, slice(0, n)) for b, n in enumerate(BATCHED_TAKE) if n]),
            # A speculative verify of 8 slots: 4 query tokens a row at the
            # end of its 2,048-token context.
            (f"cached_prefill {enc} verify 8x{VERIFY_K}",
             "cached_prefill_attention_verify" + suffix,
             prefill_case(bf16, B, VERIFY_K, H, KVH, D, 2, bs,
                          ctx_len // bs, [ctx_len - VERIFY_K] * B,
                          [VERIFY_K] * B, seed=seed + 33, int8=int8), None),
            # An FSM-constrained draft step of 8 slots: the live token is
            # the 2,048th of its context, 31 padding columns after it.
            (f"cached_prefill {enc} draft step 8x{DRAFT_STEP_W0}",
             "cached_prefill_attention_draft_step" + suffix,
             prefill_case(bf16, B, DRAFT_STEP_W0, H, KVH, D, 2, bs,
                          2 * ctx_len // bs, [ctx_len - 1] * B, [1] * B,
                          seed=seed + 34, int8=int8),
             (slice(None), slice(0, 1))),
        ]
    # OPT-125m (G = 1, D = 64): decode of 8 x 2,048 and ragged, the
    # second chunk of a 1,901-token prompt, a 1,024-token chunk over a
    # 1,024-token prefix, and a storm's batched prefill.
    oh, okv, od = OPT_HEADS["H"], OPT_HEADS["KVH"], OPT_HEADS["D"]
    for enc, seed in (("bf16", 200), ("int8", 300)):
        int8 = enc == "int8"
        suffix = "_int8" if int8 else ""
        cases += [
            (f"paged_attention opt {enc} 8x2048",
             "paged_attention_opt" + suffix,
             decode_case(bf16, B, oh, okv, od, 2, bs, ctx_len // bs,
                         [ctx_len] * B, seed=seed + 11, int8=int8), None),
            (f"paged_attention opt {enc} ragged",
             "paged_attention_opt" + suffix,
             decode_case(bf16, B, oh, okv, od, 2, bs, ctx_len // bs, ragged,
                         seed=seed + 10, int8=int8), None),
            (f"cached_prefill opt {enc} ragged chunk",
             "cached_prefill_attention_opt" + suffix,
             prefill_case(bf16, 1, 1024, oh, okv, od, 2, bs, 32, [1024],
                          [877], seed=seed + 30, int8=int8),
             (slice(None), slice(0, 877))),
            (f"cached_prefill opt {enc} 1024/1024",
             "cached_prefill_attention_opt" + suffix,
             prefill_case(bf16, 1, 1024, oh, okv, od, 2, bs, 32, [1024],
                          [1024], seed=seed + 31, int8=int8), None),
            (f"cached_prefill opt {enc} batched 4x1024",
             "cached_prefill_attention_opt" + suffix,
             batched_prefill_case(int8, seed + 32, **OPT_HEADS),
             [(b, slice(0, n)) for b, n in enumerate(BATCHED_TAKE) if n]),
        ]
    return cases


def _gathered(c, n_tokens):
    """Contiguous [B, KVH, n, D] K/V of each row's first n tokens in q's
    dtype (for the library yardstick: gathered, and for int8 pages
    dequantized, outside its timing)."""
    from production_stack_tpu_torch.ops.attention import _gather_ctx

    k = _gather_ctx(c["k_pages"], c["block_tables"], c["layer"],
                    out_dtype=c["q"].dtype)[:, :n_tokens]
    v = _gather_ctx(c["v_pages"], c["block_tables"], c["layer"],
                    out_dtype=c["q"].dtype)[:, :n_tokens]
    return (k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous())


def _page_bytes_per_token(c) -> int:
    """Bytes of one token's K and V over all kv heads in the case's page
    encoding (int8: one byte an element plus a float32 scale per head)."""
    from production_stack_tpu_torch.ops.attention import kv_page_data

    data = kv_page_data(c["k_pages"])
    KVH, D = data.shape[3], data.shape[4]
    per_head = D * data.element_size()
    if isinstance(c["k_pages"], tuple):
        per_head += 4
    return 2 * KVH * per_head


def _sdpa(q, k, v, mask=None):
    import torch.nn.functional as F

    # q arrives pre-scaled, as the kernels take it.
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          scale=1.0, enable_gqa=True)


def compare(got, want, rows=None):
    """(max_abs_err, largest error over its bar) of a kernel's output
    against its plain version's, elementwise with the bar of the dtype
    (see BF16_ROW_BAR); both are inf where the kernel's output is not
    finite."""
    import torch

    if isinstance(rows, list):
        errs = [compare(got[r], want[r]) for r in rows]
        return max(e for e, _ in errs), max(o for _, o in errs)
    if rows is not None:
        got, want = got[rows], want[rows]
    if not torch.isfinite(got).all():
        return float("inf"), float("inf")
    err = (got.float() - want.float()).abs()
    if want.dtype == torch.float32:
        bar = torch.full_like(err, F32_BAR)
    else:
        bar = BF16_ROW_BAR * want.float().abs().amax(dim=-1, keepdim=True)
    ratio = torch.where(err > 0, err / bar, torch.zeros_like(err))
    return err.max().item(), ratio.max().item()


def check_close(name, got, want, rows=None):
    """:func:`compare`, logged; raises AssertionError past the bar."""
    max_err, over = compare(got, want, rows)
    log(f"[kernel] {name}: max_abs_err={max_err:.3e} err/bar={over:.3f} "
        f"({want.dtype})")
    if not over <= 1.0:
        raise AssertionError(f"{name}: error {over:.3f}x its bar "
                             f"(max_abs_err {max_err:.3e})")
    return max_err, over


def _time_decode(label, c):
    """Device times of kernel, plain version and library yardstick on a
    decode case (``probes/timing.py``: queued behind a spin kernel, since
    a 0.05 ms launch is shorter than the host's time to make it), with
    the bytes and operations its inputs need."""
    from production_stack_tpu_torch.probes.timing import cuda_time_ms

    B, H, D = c["q"].shape
    ctx_len = int(c["context_lens"].max())
    kg, vg = _gathered(c, ctx_len)
    qs = (c["q"] * c["scale"]).to(c["q"].dtype)[:, :, None, :]
    check_close(f"{label} vs sdpa yardstick", run_decode(c),
                _sdpa(qs, kg, vg)[:, :, 0])
    n_tok = int(c["context_lens"].sum())
    q_bytes = c["q"].element_size()
    return dict(
        ms=cuda_time_ms(lambda: run_decode(c), iters=50),
        plain_ms=cuda_time_ms(lambda: plain_decode(c), iters=20),
        library_ms=cuda_time_ms(lambda: _sdpa(qs, kg, vg), iters=50),
        bytes=(n_tok * _page_bytes_per_token(c) + 2 * B * H * D * q_bytes
               + c["block_tables"].numel() * 4 + B * 4),
        ops=4 * H * D * n_tok)


def _time_prefill(label, c):
    """Device times (as :func:`_time_decode`) of kernel, plain version and
    library yardstick on a single-row cached-prefill case, with the bytes
    and operations its inputs need (the (query, key) pairs of its causal
    mask)."""
    import torch

    from production_stack_tpu_torch.probes.timing import cuda_time_ms

    _, T, H, D = c["q"].shape
    P = int(c["positions"][0, 0])
    kg, vg = _gathered(c, P + T)
    qs = (c["q"] * c["scale"]).to(c["q"].dtype).transpose(1, 2)
    span = torch.arange(P + T, device="cuda")
    mask = span[None, :] <= (P + torch.arange(T, device="cuda"))[:, None]
    check_close(f"{label} vs sdpa yardstick", run_prefill(c),
                _sdpa(qs, kg, vg, mask).transpose(1, 2))
    pairs = T * P + T * (T + 1) // 2
    return dict(
        ms=cuda_time_ms(lambda: run_prefill(c), iters=10),
        plain_ms=cuda_time_ms(lambda: plain_prefill(c), iters=5),
        library_ms=cuda_time_ms(lambda: _sdpa(qs, kg, vg, mask), iters=10),
        bytes=(2 * T * H * D * c["q"].element_size()
               + (P + T) * _page_bytes_per_token(c)
               + c["block_tables"].numel() * 4 + T * 4 + 4),
        ops=4 * H * D * pairs)


def _time_prefill_batched(label, c):
    """Device times (as :func:`_time_decode`) of kernel, plain version and
    library yardstick on a batched cached-prefill case (one masked SDPA
    call over the rows' gathered contexts), with the bytes and operations
    of the live rows' real query tokens."""
    import torch

    from production_stack_tpu_torch.probes.timing import cuda_time_ms

    B, T, H, D = c["q"].shape
    S = int(c["total_lens"].max())
    kg, vg = _gathered(c, S)
    qs = (c["q"] * c["scale"]).to(c["q"].dtype).transpose(1, 2)
    span = torch.arange(S, device="cuda")
    mask = ((span[None, None, :] <= c["positions"][:, :, None])
            & (span[None, None, :] < c["total_lens"][:, None, None]))[:, None]
    check_close(f"{label} vs sdpa yardstick", run_prefill(c),
                _sdpa(qs, kg, vg, mask).transpose(1, 2),
                [(b, slice(0, n)) for b, n in enumerate(BATCHED_TAKE) if n])
    n_q = sum(BATCHED_TAKE)
    pairs = sum(t * p + t * (t + 1) // 2
                for p, t in zip(BATCHED_PREFIX, BATCHED_TAKE))
    ctx = sum(p + t for p, t in zip(BATCHED_PREFIX, BATCHED_TAKE))
    return dict(
        ms=cuda_time_ms(lambda: run_prefill(c), iters=10),
        plain_ms=cuda_time_ms(lambda: plain_prefill(c), iters=3),
        library_ms=cuda_time_ms(lambda: _sdpa(qs, kg, vg, mask), iters=10),
        bytes=(2 * n_q * H * D * c["q"].element_size()
               + ctx * _page_bytes_per_token(c)
               + c["block_tables"].numel() * 4 + n_q * 4 + B * 4),
        ops=4 * H * D * pairs)


def _time_verify(label, c, rows=None):
    """Device times (as :func:`_time_decode`) of kernel, plain version and
    library yardstick (one SDPA call over every row's gathered context,
    each query seeing the keys up to its position; the rows share their
    positions and context) on a short-rows case, the verify's or the
    FSM-constrained draft step's (whose padding columns see the whole
    context), with the bytes and operations its inputs need; ``rows``
    are the output rows compared with the yardstick."""
    import torch

    from production_stack_tpu_torch.probes.timing import cuda_time_ms

    B, T, H, D = c["q"].shape
    S = int(c["total_lens"][0])
    pos = c["positions"][0]
    kg, vg = _gathered(c, S)
    qs = (c["q"] * c["scale"]).to(c["q"].dtype).transpose(1, 2)
    span = torch.arange(S, device="cuda")
    mask = span[None, :] <= pos[:, None]
    check_close(f"{label} vs sdpa yardstick", run_prefill(c),
                _sdpa(qs, kg, vg, mask).transpose(1, 2), rows)
    pairs = B * int(torch.clamp(pos + 1, max=S).sum())
    return dict(
        ms=cuda_time_ms(lambda: run_prefill(c), iters=50),
        plain_ms=cuda_time_ms(lambda: plain_prefill(c), iters=10),
        library_ms=cuda_time_ms(lambda: _sdpa(qs, kg, vg, mask), iters=50),
        bytes=(2 * B * T * H * D * c["q"].element_size()
               + B * S * _page_bytes_per_token(c)
               + c["block_tables"].numel() * 4 + B * T * 4 + B * 4),
        ops=4 * H * D * pairs)


def kernel_phase():
    """Kernel vs plain version at main-path and small shapes, in both page
    encodings; returns the per-entry measurements of the main-path
    (Llama-3-8B) cases."""
    import torch

    for int8 in (False, True):
        enc = "int8 pages" if int8 else "pages in q's dtype"
        for dtype, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            # Decode: small shapes (GQA 4, 1, 2, 32 and 3; odd table
            # widths; ragged contexts incl. 1 token; in bf16 several
            # splits, contexts at, below and above a split boundary and
            # more splits than live pages) and the main-path heads.
            for i, (H, KVH, D, bs, MAXB, ctx) in enumerate([
                    (8, 2, 64, 16, 5, [1, 80, 33]),
                    (4, 4, 128, 4, 7, [28, 3, 17, 9]),
                    (4, 2, 32, 4, 16, [64, 1]),
                    (32, 8, 128, 64, 4, [1, 200, 64, 130]),
                    (32, 8, 128, 4, 256, [1, 1024, 255, 256, 257, 700]),
                    (96, 3, 64, 16, 64, [1000, 1, 513])]):
                c = decode_case(dtype, len(ctx), H, KVH, D, 3, bs, MAXB, ctx,
                                seed=i, int8=int8)
                check_close(f"paged_attention {dname} case {i}, {enc}",
                            run_decode(c), plain_decode(c))
            # Cached prefill: small shapes (GQA 3, 1, 2 and 4; empty
            # prefix rows, diagonals crossing key tiles mid-tile, padded
            # rows) and the main-path heads.
            for i, (T, H, KVH, D, bs, MAXB, prefix, take) in enumerate([
                    (24, 6, 2, 64, 8, 12, [0, 17, 40], [24, 5, 13]),
                    (40, 4, 4, 128, 4, 32, [3, 64], [40, 1]),
                    (16, 4, 2, 32, 4, 16, [0, 0], [16, 7]),
                    (96, 32, 8, 128, 64, 4, [0, 100], [96, 50]),
                    (200, 12, 4, 64, 16, 32, [0, 130], [200, 77])]):
                c = prefill_case(dtype, len(prefix), T, H, KVH, D, 2, bs,
                                 MAXB, prefix, take, seed=20 + i, int8=int8)
                got, want = run_prefill(c), plain_prefill(c)
                for b, n in enumerate(take):
                    check_close(f"cached_prefill {dname} case {i} row {b}, "
                                f"{enc}", got[b, :n], want[b, :n])

    errs = {name: 0.0 for name in KERNELS}
    cases = {}
    for label, name, c, rows in main_path_cases():
        run, plain = KERNELS[name]
        got = run(c)
        err, _ = check_close(label, got, plain(c), rows)
        if "batched" in label and not torch.isfinite(got[3]).all():
            raise AssertionError(f"{label}: the padding row is not finite")
        errs[name] = max(errs[name], err)
        if ("verify" in label or "draft step" in label) and \
                not err <= F32_BAR:
            raise AssertionError(f"{label}: max_abs_err {err:.3e} above "
                                 f"{F32_BAR}")
        cases[label] = c

    from production_stack_tpu_torch.probes.common import (
        BF16_FLOPS,
        HBM_BYTES_PER_S,
    )

    results = {}
    for enc in ("bf16", "int8"):
        suffix = "_int8" if enc == "int8" else ""
        results["paged_attention" + suffix] = _time_decode(
            f"paged_attention {enc}", cases[f"paged_attention {enc} 8x2048"])
        results["cached_prefill_attention" + suffix] = _time_prefill(
            f"cached_prefill {enc}", cases[f"cached_prefill {enc} 1024/1024"])
    for enc in ("bf16", "int8"):
        suffix = "_int8" if enc == "int8" else ""
        results["paged_attention_opt" + suffix] = _time_decode(
            f"paged_attention opt {enc}",
            cases[f"paged_attention opt {enc} 8x2048"])
        results["cached_prefill_attention_opt" + suffix] = _time_prefill(
            f"cached_prefill opt {enc}",
            cases[f"cached_prefill opt {enc} 1024/1024"])
    for name, r in results.items():
        byte_ms = r["bytes"] / HBM_BYTES_PER_S * 1e3
        op_ms = r["ops"] / BF16_FLOPS * 1e3
        r.update(max_abs_err=errs[name], bound_ms=max(byte_ms, op_ms),
                 bound_by="bytes" if byte_ms >= op_ms else "operations")
        print(f"[bound] {name}: {r['bytes'] / 1e6:.2f} MB -> {byte_ms:.4f} ms "
              f"at 3.35 TB/s; {r['ops'] / 1e9:.1f} GFLOP -> {op_ms:.4f} ms at "
              f"989 TFLOP/s bf16; one launch per layer (32 a Llama-3-8B "
              f"decode step or cached chunk, 12 an OPT-125m one)",
              flush=True)
    for name, r in results.items():
        log(f"[kernel] {name}: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']})")
    batched = {}
    for enc in ("bf16", "int8"):
        r = _time_prefill_batched(
            f"cached_prefill {enc} batched",
            cases[f"cached_prefill {enc} batched 4x1024"])
        byte_ms = r.pop("bytes") / HBM_BYTES_PER_S * 1e3
        op_ms = r.pop("ops") / BF16_FLOPS * 1e3
        single = results["cached_prefill_attention"
                         + ("_int8" if enc == "int8" else "")]
        batched[enc] = dict(r, bound_ms=max(byte_ms, op_ms),
                            bound_by="bytes" if byte_ms >= op_ms
                            else "operations", single_row_ms=single["ms"])
        log(f"[kernel] cached_prefill {enc} batched 4x1024: "
            f"{json.dumps(batched[enc])}")
    print(json.dumps({"batched_prefill": batched}), flush=True)
    # The verify shape: the bf16 entry joins the kernels line (the spec
    # serve phase launches it); both encodings go on a line of their own.
    verify = {}
    for enc in ("bf16", "int8"):
        name = "cached_prefill_attention_verify" + (
            "_int8" if enc == "int8" else "")
        r = _time_verify(f"cached_prefill {enc} verify",
                         cases[f"cached_prefill {enc} verify 8x{VERIFY_K}"])
        byte_ms = r.pop("bytes") / HBM_BYTES_PER_S * 1e3
        op_ms = r.pop("ops") / BF16_FLOPS * 1e3
        verify[enc] = dict(r, max_abs_err=errs[name],
                           bound_ms=max(byte_ms, op_ms),
                           bound_by="bytes" if byte_ms >= op_ms
                           else "operations",
                           decode_ms=results["paged_attention" + (
                               "_int8" if enc == "int8" else "")]["ms"])
        log(f"[kernel] cached_prefill {enc} verify 8x{VERIFY_K}: "
            f"{json.dumps(verify[enc])}")
    print(json.dumps({"verify_prefill": verify}), flush=True)
    results["cached_prefill_attention_verify"] = verify["bf16"]
    # The FSM-constrained draft step, beside the decode kernel over the
    # same contexts: the bf16 entry joins the kernels line (the
    # self-drafting run's grammar rows launch it).
    draft_step = {}
    for enc in ("bf16", "int8"):
        suffix = "_int8" if enc == "int8" else ""
        name = "cached_prefill_attention_draft_step" + suffix
        r = _time_verify(
            f"cached_prefill {enc} draft step",
            cases[f"cached_prefill {enc} draft step 8x{DRAFT_STEP_W0}"],
            (slice(None), slice(0, 1)))
        byte_ms = r.pop("bytes") / HBM_BYTES_PER_S * 1e3
        op_ms = r.pop("ops") / BF16_FLOPS * 1e3
        draft_step[enc] = dict(r, max_abs_err=errs[name],
                               bound_ms=max(byte_ms, op_ms),
                               bound_by="bytes" if byte_ms >= op_ms
                               else "operations",
                               decode_ms=results["paged_attention"
                                                 + suffix]["ms"])
        log(f"[kernel] cached_prefill {enc} draft step 8x{DRAFT_STEP_W0}: "
            f"{json.dumps(draft_step[enc])}")
    print(json.dumps({"draft_step_prefill": draft_step}), flush=True)
    results["cached_prefill_attention_draft_step"] = draft_step["bf16"]
    return results


# -- probe phase --------------------------------------------------------------

# A probe that reads faster than this many times the card's memory rate
# (``probes.common.HBM_BYTES_PER_S``) copied less than it claims: the
# planted dma_only fault of scripts/torch_kernel_faults.py (only the
# consumed rows copied) reads above it.
PROBE_RATE_FACTOR = 1.05
# Probe kernel vs plain version, of the largest |plain| value: the same
# float32 sums of page values in another order (atomics on the card);
# dots adds float32 products of D terms, then of up to P * bs tokens.
PROBE_GATHER_TOL = 1e-6
PROBE_DOTS_TOL = 1e-5
# The JAX scripts' shapes (benchmarks/kernel_dma_only.py:26-27, G from
# kernel_probe_strided.py:27), and the Llama-3-8B decode case of the
# kernel phase (8 x 2,048, 64-token pages, 32/8 heads) at the model's 32
# layers, so that one call's pool (2.15 GB) is far beyond the 50 MB L2.
JAX_PROBE_SHAPE = dict(B=16, MAXB=64, NB=843, ctx=3000, L=16, bs=64, KVH=8,
                       D=128, G=8)
DECODE_PROBE_SHAPE = dict(B=8, MAXB=32, NB=8 * 32 + 3, ctx=2048, L=32,
                          bs=64, KVH=8, D=128, G=4)
# P of each sweep: the gather, then reads and dots, from a split of the
# context over many blocks to one block a sequence (P = MAXB). The probe
# phase adds the decode kernel's own P (:func:`decode_plan`) to each,
# where the decode kernel's time is split (:func:`decode_decomposition`).
PROBE_SWEEPS = {"jax_shapes": ((4, 8, 16, 64), (8, 64)),
                "decode_case": ((4, 8, 16, 32), (4, 32))}
PROBE_DTYPES = ("bf16", "int8")  # page dtypes of the kernels line


def probe_inputs(shape, dtype, seed=0):
    """(q, k, v, tables, lens) of a probe run on the card: pages of
    ``dtype``, bf16 q of KVH * G rows."""
    import torch

    from production_stack_tpu_torch.probes import common

    s = dict(shape)
    G = s.pop("G")
    k, v, bt, cl = common.make_inputs(dtype=dtype, device="cuda", seed=seed,
                                      **s)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    q = torch.randn((s["B"], s["KVH"] * G, s["D"]), generator=g,
                    device="cuda", dtype=torch.bfloat16)
    return q, k, v, bt, cl


def probe_compare(kind, inputs, P, layer):
    """(max_abs_err, error over its bar) of one probe launch against its
    plain version on the same inputs (``kind``: dma_only, reads, dots)."""
    from production_stack_tpu_torch.probes import kernel_dma_only as kdma
    from production_stack_tpu_torch.probes import kernel_probe_strided as kst

    q, k, v, bt, cl = inputs
    if kind == "dma_only":
        got = kdma.dma_only(k, v, bt, cl, layer, pages_per_block=P)
        want = kdma.dma_only_reference(k, v, bt, cl, layer,
                                       pages_per_block=P)
    else:
        got = kst.probe_strided(q, k, v, bt, cl, layer, mode=kind,
                                pages_per_block=P)
        want = kst.probe_strided_reference(q, k, v, bt, cl, layer, mode=kind,
                                           pages_per_block=P)
    tol = PROBE_DOTS_TOL if kind == "dots" else PROBE_GATHER_TOL
    if not bool(got.isfinite().all()):
        return float("inf"), float("inf")
    err = (got - want).abs().max().item()
    bar = tol * max(want.abs().max().item(), 1e-30)
    return err, err / bar


def check_probe(label, kind, inputs, P, layer):
    """:func:`probe_compare`, logged; raises past the bar."""
    err, over = probe_compare(kind, inputs, P, layer)
    log(f"[probe] {label}: max_abs_err={err:.3e} err/bar={over:.3f}")
    if not over <= 1.0:
        raise AssertionError(f"{label}: error {over:.3f}x its bar")
    return err


def check_probe_rate(label, nbytes, seconds):
    """Raise if a probe read faster than the card's memory can deliver."""
    from production_stack_tpu_torch.probes.common import HBM_BYTES_PER_S

    rate = nbytes / seconds
    if rate > PROBE_RATE_FACTOR * HBM_BYTES_PER_S:
        raise AssertionError(
            f"{label}: {rate / 1e12:.2f} TB/s is above 1.05 x 3.35 TB/s: "
            f"the probe copied less than it counts")
    return rate


def _probe_counters():
    """The launch counter of each probe entry: (wrapper, attribute)."""
    from production_stack_tpu_torch.probes.kernel_dma_only import dma_only
    from production_stack_tpu_torch.probes.kernel_probe_strided import (
        MODES,
        probe_strided,
    )

    out = {f"kernel_dma_only_{d}": (dma_only, f"launches_{d}")
           for d in PROBE_DTYPES}
    out.update({f"kernel_probe_strided_{m}_{d}": (probe_strided,
                                                   f"launches_{m}_{d}")
                for m in MODES for d in PROBE_DTYPES})
    return out


def _decode_all_layers_ms(q, k, v, bt, cl, dtype):
    """Device ms of the port's decode kernel over every layer of a probe
    pool at contexts ``cl`` (int8 pages get the strided probe's unit
    scales, so the kernel does its dequant as the probe does)."""
    import torch

    from production_stack_tpu_torch.ops.paged_attention import (
        paged_attention,
    )
    from production_stack_tpu_torch.probes.common import unit_scales
    from production_stack_tpu_torch.probes.timing import cuda_time_ms

    L, NB, bs, KVH, D = k.shape
    if dtype == torch.int8:
        ks, vs = unit_scales(k)
        k, v = (k, ks), (v, vs)

    def call():
        for layer in range(L):
            paged_attention(q, k, v, bt, cl, layer, scale=D ** -0.5)

    return cuda_time_ms(call)


def _plain_run(mode, P, q, k, v, bt, cl):
    """The plain version of ``build(mode, P)``'s run."""
    import torch

    from production_stack_tpu_torch.probes import kernel_probe_strided as kst

    acc = torch.zeros(8, device=q.device)
    for layer in range(k.shape[0]):
        acc += kst.probe_strided_reference(
            q, k, v, bt, cl, layer, mode=mode, pages_per_block=P)[0, 0, :8]
    return acc.reshape(1, 8)


def _live_runs(ctx, MAXB, bs, pages):
    """Runs of ``pages`` pages that hold a key, summed over sequences of
    contexts ``ctx`` (one length, or one a sequence) in a table of MAXB."""
    lens = [ctx] if isinstance(ctx, int) else list(ctx)
    return sum(min(-(-MAXB // pages), -(-min(c, MAXB * bs) // (pages * bs)))
               for c in lens)


def decode_plan(B, KVH, MAXB, bs, H, sms, ctx):
    """The decode kernel's split plan on a probe pool of ``B`` sequences
    of ``MAXB`` pages, ``H`` query rows and contexts ``ctx``: its
    ``splits``, the pages of a split (``P``), the nearest P at or below
    that divides the table (``floor_P``: the probes take only such a P),
    and whether the probes' grid at ``floor_P`` has as many blocks with
    keys as the decode kernel's (``grids_match``)."""
    from production_stack_tpu_torch.ops.paged_attention import (
        ROW_TILE,
        split_pages,
        split_plan,
    )

    splits = split_plan(B, KVH, MAXB, bs, row_tiles=-(-(H // KVH) // ROW_TILE),
                        sms=sms)
    P = split_pages(MAXB, splits)
    floor_P = max(p for p in range(1, P + 1) if MAXB % p == 0)
    return {"splits": splits, "P": P, "floor_P": floor_P,
            "grids_match": (_live_runs(ctx, MAXB, bs, P)
                            == _live_runs(ctx, MAXB, bs, floor_P))}


def _shape_plan(shape):
    """:func:`decode_plan` of a probe shape on this card."""
    import torch

    return decode_plan(
        shape["B"], shape["KVH"], shape["MAXB"], shape["bs"],
        shape["KVH"] * shape["G"],
        torch.cuda.get_device_properties(0).multi_processor_count,
        shape["ctx"])


def decode_decomposition(rows, plan):
    """The decode kernel's time over every layer of a probe pool, split by
    the probes at its plan's P (``plan``: :func:`decode_plan`; ``rows``:
    the probe sweeps of that pool and ``decode_kernel_all_L_s``): the
    whole-row gather floor (``dma_only``, the load floor the decode
    kernel is held to), the per-head ring gather with the int8 staging
    (``reads``), the products (``dots - reads``, with the probe's one
    extra S . V product a 16-key step), and the online softmax and split
    merge (the decode kernel minus ``dots``). That last one is measured
    only where the probes' grid has the decode kernel's blocks; else it
    is None, and ``softmax_merge_note`` says why. Seconds, and the decode
    kernel's and the ring gather's multiples of the floor."""
    P = plan["floor_P"]
    floor_s = rows[f"dma_only_P{P}"]["dma_only_all_L_s"]
    reads_s = rows[f"reads_P{P}"]["all_L_s"]
    dots_s = rows[f"dots_P{P}"]["all_L_s"]
    decode_s = rows["decode_kernel_all_L_s"]
    out = {"P": P, "plan_pages": plan["P"], "splits": plan["splits"],
           "decode_kernel_s": decode_s, "gather_floor_s": floor_s,
           "ring_gather_s": reads_s, "products_s": dots_s - reads_s,
           "softmax_merge_s": decode_s - dots_s,
           "ring_gather_over_floor": reads_s / floor_s,
           "decode_over_floor": decode_s / floor_s}
    if not plan["grids_match"]:
        out["softmax_merge_s"] = None
        out["softmax_merge_note"] = (
            f"not measured: the probes split the table at P={P}, the "
            f"decode kernel at {plan['P']} pages, so their grids differ "
            f"in blocks with keys")
    return out


def probe_phase():
    """Both probe kernels against their plain versions (small shapes, the
    8B decode case, the JAX shapes; every mode and page dtype), then the
    probe path driven through its entry points with every probe counter
    set to 0 just before and read just after: at both shapes the
    ``dma_only``, ``reads`` and ``dots`` sweeps of ``PROBE_SWEEPS`` and
    the decode kernel's own P (and the contiguous yardstick at the JAX
    shapes), each held to the rate limit, and the decode kernel on the
    same pools, its time split by the probes at its own split
    (:func:`decode_decomposition`). Returns (per-entry measurements, the
    ``probes`` summary)."""
    import torch

    from production_stack_tpu_torch.probes import kernel_dma_only as kdma
    from production_stack_tpu_torch.probes import kernel_probe_strided as kst
    from production_stack_tpu_torch.probes.common import (
        BF16_FLOPS,
        HBM_BYTES_PER_S,
    )
    from production_stack_tpu_torch.probes.timing import cuda_time_ms

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16,
              "int8": torch.int8}
    kinds = ("dma_only", "reads", "dots")
    # Small shapes: ragged contexts incl. 0 and 1 token, GQA 3 and 6,
    # pages of 4-16 tokens, every head dim the kernel is built for.
    for i, (bs, KVH, D, G, MAXB, ctx) in enumerate([
            (16, 2, 64, 3, 8, [1, 40, 0, 128]),
            (8, 4, 128, 6, 12, [96, 0, 17, 1]),
            (4, 1, 32, 8, 16, [64, 33, 1, 0])]):
        shape = dict(B=4, MAXB=MAXB, NB=4 * MAXB + 3, ctx=ctx, L=2, bs=bs,
                     KVH=KVH, D=D, G=G)
        for name, dtype in dtypes.items():
            inputs = probe_inputs(shape, dtype, seed=i)
            for kind in kinds:
                if kind == "dma_only" and bs < 8:
                    continue
                for P in (1, 2, 4):
                    if kind != "dma_only" and G > P * bs:
                        continue
                    check_probe(f"{kind} small case {i} {name} P={P}", kind,
                                inputs, P, 1)
    errs = {name: 0.0 for name in _probe_counters()}

    def entry(kind, dname):
        if kind == "dma_only":
            return f"kernel_dma_only_{dname}"
        return f"kernel_probe_strided_{kind}_{dname}"

    shapes = {"decode_case": DECODE_PROBE_SHAPE,
              "jax_shapes": JAX_PROBE_SHAPE}
    plans = {label: _shape_plan(shape) for label, shape in shapes.items()}
    # Each sweep's P (the gather's, then reads' and dots') and the decode
    # kernel's own.
    sweeps = {label: [sorted(set(ps) | {plans[label]["floor_P"]})
                      for ps in PROBE_SWEEPS[label]] for label in shapes}
    for label, shape in shapes.items():
        for dname in PROBE_DTYPES:
            inputs = probe_inputs(shape, dtypes[dname])
            for kind in kinds:
                for P in sweeps[label][1]:
                    err = check_probe(f"{kind} {label} {dname} P={P}", kind,
                                      inputs, P, shape["L"] - 1)
                    errs[entry(kind, dname)] = max(errs[entry(kind, dname)],
                                                   err)
            if label == "jax_shapes":
                # The JAX scripts' checksum, over every layer.
                for mode in kst.MODES:
                    got = kst.build(mode, 8)(*inputs)
                    want = _plain_run(mode, 8, *inputs)
                    err = (got - want).abs().max().item()
                    tol = PROBE_DOTS_TOL if mode == "dots" else \
                        PROBE_GATHER_TOL
                    log(f"[probe] {mode} {label} {dname} run checksum: "
                        f"max_abs_err={err:.3e}")
                    if not err <= tol * max(want.abs().max().item(), 1e-30):
                        raise AssertionError(f"{mode} {dname}: run checksum "
                                             f"off by {err:.3e}")
                    errs[entry(mode, dname)] = max(errs[entry(mode, dname)],
                                                   err)
            del inputs
            _free_device_memory()

    counters = _probe_counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    summary = {"jax_shapes": {}, "decode_case": {}}
    results = {}
    for dname in PROBE_DTYPES:
        dtype = dtypes[dname]
        for label, shape in (("jax_shapes", JAX_PROBE_SHAPE),
                             ("decode_case", DECODE_PROBE_SHAPE)):
            q, k, v, bt, cl = probe_inputs(shape, dtype)
            rows = {}
            if label == "jax_shapes":
                contig = kdma.contiguous_row(k)
                check_probe_rate(f"torch.sum {dname}",
                                 contig["pool_gb"] * 1e9,
                                 contig["contiguous_sum_s"])
                rows["contiguous"] = contig
            gather_ps, strided_ps = sweeps[label]
            for P in gather_ps:
                row = kdma.sweep_row(k, v, bt, cl, P)
                check_probe_rate(f"dma_only {label} {dname} P={P}",
                                 row["bytes_gb"] * 1e9,
                                 row["dma_only_all_L_s"])
                rows[f"dma_only_P{P}"] = row
            for mode in kst.MODES:
                for P in strided_ps:
                    row = kst.sweep_row(q, k, v, bt, cl, mode, P)
                    check_probe_rate(f"{mode} {label} {dname} P={P}",
                                     row["bytes_gb"] * 1e9, row["all_L_s"])
                    rows[f"{mode}_P{P}"] = row
            rows["decode_kernel_all_L_s"] = _decode_all_layers_ms(
                q, k, v, bt, cl, dtype) / 1e3
            rows["decode_decomposition"] = decode_decomposition(
                rows, plans[label])
            rows["split_gather_headroom"] = (
                rows[f"dma_only_P{gather_ps[-1]}"]["dma_only_all_L_s"]
                / rows[f"dma_only_P{gather_ps[0]}"]["dma_only_all_L_s"])
            summary[label][dname] = rows
            log(f"[probe] {label} {dname}: {json.dumps(rows)}")
            if label == "jax_shapes":
                # The kernels line: each entry at P=8, the JAX scripts'
                # default.
                L = k.shape[0]
                dma8 = rows["dma_only_P8"]
                plain_dma = cuda_time_ms(lambda: kdma.dma_only_reference(
                    k, v, bt, cl, L - 1, pages_per_block=8), iters=5)
                results[f"kernel_dma_only_{dname}"] = dict(
                    ms=dma8["dma_only_all_L_s"] * 1e3 / L,
                    plain_ms=plain_dma, bytes=dma8["bytes_gb"] * 1e9 / L,
                    ops=0)
                for mode in kst.MODES:
                    row = rows[f"{mode}_P8"]
                    results[f"kernel_probe_strided_{mode}_{dname}"] = dict(
                        ms=row["all_L_s"] * 1e3,
                        plain_ms=cuda_time_ms(lambda mode=mode: _plain_run(
                            mode, 8, q, k, v, bt, cl), iters=3, warmup=1),
                        bytes=row["bytes_gb"] * 1e9, ops=row["gflop"] * 1e9)
            del q, k, v, bt, cl
            _free_device_memory()
    launches = {name: getattr(fn, attr)
                for name, (fn, attr) in counters.items()}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the probe path")
    for name, r in results.items():
        byte_ms = r["bytes"] / HBM_BYTES_PER_S * 1e3
        op_ms = r["ops"] / BF16_FLOPS * 1e3
        r.update(max_abs_err=errs[name], launches=launches[name],
                 bound_ms=max(byte_ms, op_ms),
                 bound_by="bytes" if byte_ms >= op_ms else "operations",
                 library_ms=None)
        log(f"[probe] {name}: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"launches={r['launches']}")
    return results, summary


# -- served main path ---------------------------------------------------------

# The JAX engine's default step: prefill batching at EngineConfig's 4 rows
# (the JAX server's flag defaults to 1), the step recorder on, pipelined
# decode bursts.
SERVE_ARGS = ["meta-llama/Llama-3-8B", "--device", "cuda", "--host",
              "127.0.0.1", "--port", "0", "--max-model-len", "4096",
              "--max-num-seqs", "8", "--seed", "0", "--prefill-batch", "4"]
CHUNKED_ARGS = ["--enable-chunked-prefill", "--max-num-batched-tokens",
                "512", "--max-num-seqs", "10"]
# The chunked and fused phases' one-at-a-time segment: this many short
# prompts, then a long one.
SERIAL_SHORTS = 3
INT8_ARGS = ["--kv-cache-dtype", "int8", "--quantization", "int8"]
REQUIRED_SERIES = (
    "vllm:num_requests_running", "vllm:num_requests_waiting",
    "vllm:gpu_cache_usage_perc", "vllm:gpu_prefix_cache_hits_total",
    "vllm:gpu_prefix_cache_queries_total", "tpu:hbm_kv_usage_perc",
    "tpu:prefix_cache_hits_total", "tpu:prefix_cache_queries_total",
    "tpu:hbm_headroom_bytes")


def _text(seed: int, n_chars: int) -> str:
    import numpy as np

    words = ["paged", "attention", "serves", "every", "decode", "step",
             "while", "prefix", "pages", "stay", "resident", "on", "the",
             "card", "and", "chunks", "stream", "through", "kernels"]
    rng = np.random.default_rng(seed)
    out = ""
    while len(out) < n_chars:
        out += words[int(rng.integers(len(words)))] + " "
    return out[:n_chars]


class Client:
    def __init__(self, port: int, headers=None):
        self.base = f"http://127.0.0.1:{port}"
        self.headers = dict(headers or {})  # e.g. the deployment key

    def post(self, path: str, body: dict, stream: bool = False):
        import urllib.request

        req = urllib.request.Request(
            self.base + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json", **self.headers})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as resp:
            if not stream:
                out = json.loads(resp.read().decode())
                out["_latency_s"] = time.perf_counter() - t0
                return out
            text, finish, first_s = "", None, None
            for raw in resp:
                line = raw.decode().strip()
                if not line.startswith("data: ") or line == "data: [DONE]":
                    continue
                choice = json.loads(line[6:])["choices"][0]
                piece = (choice.get("delta", {}).get("content")
                         or choice.get("text") or "")
                if piece and first_s is None:
                    first_s = time.perf_counter() - t0
                text += piece
                finish = choice.get("finish_reason") or finish
            return {"text": text, "finish_reason": finish,
                    "_latency_s": time.perf_counter() - t0,
                    "_first_token_s": first_s}

    def get(self, path: str) -> str:
        import urllib.request

        req = urllib.request.Request(self.base + path, headers=self.headers)
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.read().decode()


def _finish(name: str, out: dict) -> str:
    if "choices" in out:
        finish = out["choices"][0]["finish_reason"]
    else:
        finish = out["finish_reason"]
    if finish not in ("stop", "length"):
        raise AssertionError(f"{name}: finish_reason {finish!r}")
    return finish


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _counters():
    """The launch counter of each kernel entry: (wrapper, attribute); the
    probes' too, so that a served run shows it never launched them."""
    from production_stack_tpu_torch.ops.paged_attention import paged_attention
    from production_stack_tpu_torch.ops.prefill_attention import (
        cached_prefill_attention,
    )

    return {"paged_attention": (paged_attention, "launches"),
            "cached_prefill_attention": (cached_prefill_attention,
                                         "launches"),
            "paged_attention_int8": (paged_attention, "launches_int8"),
            "cached_prefill_attention_int8": (cached_prefill_attention,
                                              "launches_int8"),
            **_probe_counters()}


def _weight_bytes(params):
    """(bytes stored, bytes a decode step's products move): an int8 leaf
    with its scale is read as int8, then copied to bf16 and that copy read
    by the product (1 + 2 + 2 bytes a weight); other leaves are read
    once."""
    import torch

    stored = moved = 0
    for t in _leaves(params):
        n = t.numel() * t.element_size()
        stored += n
        moved += 5 * t.numel() if t.dtype == torch.int8 else n
    return stored, moved


def serve_phase(label: str, extra_args, entries, base_args=SERVE_ARGS,
                long_chars=2500, hit_chars=2000, after=None):
    """Serve Llama-3-8B (or ``base_args``'s model) through the port's
    server (``base_args`` plus ``extra_args``) and drive it over HTTP:
    the long prompt has ``long_chars`` tokens, the prefix hit shares its
    first ``hit_chars``. Every launch counter is set to 0 just before the
    drive and read just after, and each kind of work must launch its
    kernel: decode the decode kernel, a chunk continuation, a prefix hit
    and a storm the cached-prefill kernel. ``after(core)``, when given,
    runs on the stopped engine and its result joins the summary. Returns
    (launch counts of the served run by kernel entry, summary); raises
    unless each of ``entries`` launched and no other entry did."""
    import threading

    from production_stack_tpu_torch.engine.server import build_server
    from production_stack_tpu_torch.probes.common import HBM_BYTES_PER_S

    import torch

    t0 = time.time()
    httpd, core = build_server(list(base_args) + list(extra_args))
    torch.cuda.synchronize()
    init_s = time.time() - t0
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    client = Client(httpd.server_address[1])
    stored, moved = _weight_bytes(core.params)
    print(f"[bound] {label} weights: {stored / 1e9:.2f} GB stored -> "
          f"{stored / HBM_BYTES_PER_S * 1e3:.2f} ms per decode step at "
          f"3.35 TB/s; the products move {moved / 1e9:.2f} GB -> "
          f"{moved / HBM_BYTES_PER_S * 1e3:.2f} ms", flush=True)
    summary = {"config": label, "init_s": init_s,
               "num_blocks": core.num_blocks,
               "kv_cache_dtype": core.stats()["kv_cache_dtype"],
               "weight_bytes": stored,
               "weight_read_bound_ms_per_step":
                   stored / HBM_BYTES_PER_S * 1e3,
               "weight_moved_bound_ms_per_step":
                   moved / HBM_BYTES_PER_S * 1e3,
               "device_memory_allocated_gb":
                   torch.cuda.memory_allocated() / 1e9}
    try:
        # Warm-up (first-use library set-up of every GEMM shape, the
        # kernels' first launches): a prefill, a chunk continuation and a
        # decode burst, outside the measured run.
        _finish("warm-up", client.post("/v1/completions", {
            "prompt": _text(99, 1100), "max_tokens": 9, "temperature": 0}))
        base = core.stats()
        counters = _counters()
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        decode_fn, prefill_fn = (counters[entries[0]], counters[entries[1]])
        by_kind = {}

        def launched(kind, fn_attr, since):
            """The launches of one kernel since ``since`` by the kind of
            work just driven; a kind that launched nothing fails."""
            n = getattr(*fn_attr) - since
            if n <= 0:
                raise AssertionError(f"{label}: {kind} launched no "
                                     f"{fn_attr[1]} of {fn_attr[0].__name__}")
            by_kind[kind] = n
            return getattr(*fn_attr)

        t_run = time.time()
        # Four concurrent greedy completions: a decode batch of 4. The
        # first prompt is shorter than one 64-token page, so its repeat
        # below cannot hit the prefix cache and recomputes exactly as the
        # first run did (a cache hit takes the cached-prefill path, whose
        # other bf16 rounding may flip a near-tied greedy token).
        prompts = [_text(i, 50 + 80 * i) for i in range(4)]
        results = [None] * 4

        def run(i):
            results[i] = client.post("/v1/completions", {
                "prompt": prompts[i], "max_tokens": 32, "temperature": 0})

        threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        for i, out in enumerate(results):
            if out is None:
                raise AssertionError(f"concurrent request {i} got no reply")
            _finish(f"concurrent {i}", out)
        launched("decode", decode_fn, 0)
        mark = getattr(*prefill_fn)
        # A ~2,500-token prompt: chunks of 1024 + 1024 + the rest, the
        # later ones through the cached-prefill kernel.
        long_prompt = _text(10, long_chars)
        long_out = client.post("/v1/completions", {
            "prompt": long_prompt, "max_tokens": 16, "temperature": 0})
        _finish("long prompt", long_out)
        mark = launched("chunk continuation", prefill_fn, mark)
        # Shares its first 2,000 characters: a prefix-cache hit.
        hit_out = client.post("/v1/completions", {
            "prompt": long_prompt[:hit_chars] + _text(11, 500),
            "max_tokens": 16, "temperature": 0})
        _finish("prefix hit", hit_out)
        mark = launched("prefix hit", prefill_fn, mark)
        chat_out = client.post("/v1/chat/completions", {
            "messages": [{"role": "user", "content": _text(12, 200)}],
            "max_tokens": 24, "temperature": 0.8, "seed": 7,
            "stream": True}, stream=True)
        _finish("streamed chat", chat_out)
        again = client.post("/v1/completions", {
            "prompt": prompts[0], "max_tokens": 32, "temperature": 0})
        _finish("repeat", again)
        if again["choices"][0]["text"] != results[0]["choices"][0]["text"]:
            raise AssertionError("repeated greedy request gave another text")
        for name, out in [("concurrent 0", results[0]), ("long", long_out),
                          ("hit", hit_out)]:
            usage = out["usage"]
            want = 32 if name.startswith("concurrent") else 16
            if out["choices"][0]["finish_reason"] == "length" and \
                    usage["completion_tokens"] != want:
                raise AssertionError(f"{name}: usage {usage}")
        if not chat_out["text"]:
            raise AssertionError("streamed chat returned no text")
        # An arrival storm: six ~2,000-token prompts at once, none cached,
        # so the storm gate opens (two or more qualifying prompts wait)
        # and their chunks ride [4, 1024] batched prefills.
        storm = [None] * 6

        def storm_run(i):
            storm[i] = client.post("/v1/completions", {
                "prompt": _text(40 + i, 2000), "max_tokens": 8,
                "temperature": 0})

        threads = [threading.Thread(target=storm_run, args=(i,))
                   for i in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        for i, out in enumerate(storm):
            if out is None:
                raise AssertionError(f"storm request {i} got no reply")
            _finish(f"storm {i}", out)
        launched("storm", prefill_fn, mark)
        # A seeded sampled request, sent twice, alone each time and shorter
        # than a page (no prefix hit): the same keyed draws, the same text.
        seeded = [client.post("/v1/completions", {
            "prompt": _text(50, 40), "max_tokens": 32, "temperature": 0.8,
            "top_p": 0.95, "seed": 1234}) for _ in range(2)]
        for out in seeded:
            _finish("seeded", out)
        if seeded[0]["choices"][0]["text"] != seeded[1]["choices"][0]["text"]:
            raise AssertionError("a seeded sampled request gave two texts")
        steps_doc = json.loads(client.get("/debug/steps?limit=1024"))
        metrics = client.get("/metrics")
        launches = {name: getattr(fn, attr)
                    for name, (fn, attr) in counters.items()}
        missing = [m for m in REQUIRED_SERIES if m not in metrics]
        if missing:
            raise AssertionError(f"/metrics lacks {missing}")
        kv_label = f'kv_cache_dtype="{summary["kv_cache_dtype"]}"'
        if not any(line.startswith("tpu:kv_cache_bytes_per_token{")
                   and kv_label in line for line in metrics.splitlines()):
            raise AssertionError(
                f"/metrics: tpu:kv_cache_bytes_per_token lacks {kv_label}")
        now = core.stats()
        stats = {k: now[k] - base[k] for k in (
            "prefix_cache_hits", "prefill_time_total", "decode_time_total",
            "decode_forward_steps_total", "prefill_chunks_total",
            "cached_tokens_total", "prompt_tokens_total",
            "generation_tokens_total", "prefill_group_count",
            "prefill_group_rows", "prefill_batched_dispatch_total",
            "flush_time_total", "decode_burst_count")}
        if stats["prefix_cache_hits"] <= 0:
            raise AssertionError("no prefix-cache hit was served")
        if stats["prefill_batched_dispatch_total"] <= 0:
            raise AssertionError("the storm ran no batched prefill")
        recorder = recorder_summary(steps_doc, metrics, core)
        summary.update(
            run_s=time.time() - t_run,
            concurrent_latency_s=[r["_latency_s"] for r in results],
            long_latency_s=long_out["_latency_s"],
            hit_latency_s=hit_out["_latency_s"],
            chat_first_token_s=chat_out["_first_token_s"],
            chat_latency_s=chat_out["_latency_s"],
            prefill_time_s=stats["prefill_time_total"],
            decode_time_s=stats["decode_time_total"],
            decode_forward_steps=stats["decode_forward_steps_total"],
            decode_ms_per_step=1e3 * stats["decode_time_total"]
            / max(stats["decode_forward_steps_total"], 1),
            prefill_chunks=stats["prefill_chunks_total"],
            cached_tokens=stats["cached_tokens_total"],
            prompt_tokens=stats["prompt_tokens_total"],
            generation_tokens=stats["generation_tokens_total"],
            storm_latency_s=[r["_latency_s"] for r in storm],
            prefill_groups=stats["prefill_group_count"],
            prefill_group_rows=stats["prefill_group_rows"],
            batched_prefill_dispatches=stats["prefill_batched_dispatch_total"],
            decode_bursts=stats["decode_burst_count"],
            flush_time_s=stats["flush_time_total"],
            seeded_text=seeded[0]["choices"][0]["text"][:40],
            recorder=recorder,
            launches=launches,
            launches_by_kind=by_kind,
            sample_text=results[0]["choices"][0]["text"][:40])
    finally:
        httpd.shutdown()
        httpd.server_close()
        core.stop()
    if after is not None:
        summary.update(after(core))
    for name, n in launches.items():
        if name in entries and n <= 0:
            raise AssertionError(f"{name} never launched on the {label} "
                                 f"served path")
        if name not in entries and n != 0:
            raise AssertionError(f"{name} launched {n} times on the {label} "
                                 f"served path, which does not use it")
    return {name: launches[name] for name in entries}, summary


def recorder_summary(steps_doc: dict, metrics: str, core) -> dict:
    """What the step recorder saw of a served run: step kinds and their
    counts from ``/debug/steps``, the ``tpu:step_*`` scrape, and the
    bandwidth share of the recent steps against the card's memory rate
    (the recorder's 3.35e12 B/s). Raises if a series is missing."""
    kinds = {}
    for rec in steps_doc["steps"]:
        kinds[rec["kind"]] = kinds.get(rec["kind"], 0) + 1
    scrape = [line for line in metrics.splitlines()
              if line.startswith(("tpu:step_", "tpu:model_bandwidth"))]
    for family in ("tpu:step_duration_seconds_sum",
                   "tpu:step_duration_seconds_count",
                   "tpu:step_scheduled_tokens_total",
                   "tpu:step_hbm_bytes_total",
                   "tpu:model_bandwidth_utilization"):
        if not any(line.startswith(family + "{") for line in scrape):
            raise AssertionError(f"/metrics lacks {family}")
    return {"kinds": kinds, "recorded_total": steps_doc["recorded_total"],
            "hbm_bytes_per_s": steps_doc["hbm_bytes_per_s"],
            "param_bytes": steps_doc["param_bytes"],
            "bandwidth_utilization": steps_doc["bandwidth_utilization"],
            "stats_bandwidth_utilization":
                core.stats()["model_bandwidth_utilization"],
            "scrape": [line for line in scrape
                       if 'kind="prefill' in line or 'kind="decode' in line
                       or line.startswith("tpu:model_bandwidth")]}


def _chunked_serve(label: str, extra_args, entries):
    """Serve Llama-3-8B in bf16 with chunked-prefill step plans
    (``SERVE_ARGS`` plus ``CHUNKED_ARGS``: a 512-token step budget, ten
    slots; plus ``extra_args``) and drive it over HTTP in two segments:

    - concurrent: eight short prompts arrive together (their admissions
      share batched ``[rows, chunk]`` step plans), then, once the eight
      run, two ~2,000-token prompts arrive together and prefill in
      512-token step plans while the eight decode (a plan holds the first
      long's last chunk and the second's first tokens);
    - one at a time: ``SERIAL_SHORTS`` short prompts, then a ~2,000-token
      prompt, each sent once the one before holds a decode slot, so that
      each request's step plans (and so its prefill shapes) are the same
      under any schedule of plans and bursts: the chunked and the fused
      phases must give this segment the same greedy streams.

    Counters as in :func:`serve_phase`. Returns (launch counts by kernel
    entry, summary, the texts of both segments, the run's step records,
    stats deltas)."""
    import threading

    import torch

    from production_stack_tpu_torch.engine.server import build_server

    httpd, core = build_server(SERVE_ARGS + CHUNKED_ARGS + list(extra_args))
    torch.cuda.synchronize()
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    client = Client(httpd.server_address[1])
    try:
        _finish("warm-up", client.post("/v1/completions", {
            "prompt": _text(98, 1100), "max_tokens": 9, "temperature": 0}))
        base = core.stats()
        base_step = json.loads(client.get("/debug/steps?limit=1"))[
            "recorded_total"]
        counters = _counters()
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        t_run = time.time()
        n_serial = SERIAL_SHORTS + 1
        outs = [None] * (10 + n_serial)

        def run(i, prompt, max_tokens):
            outs[i] = client.post("/v1/completions", {
                "prompt": prompt, "max_tokens": max_tokens,
                "temperature": 0})

        def start(i, prompt, max_tokens):
            th = threading.Thread(target=run, args=(i, prompt, max_tokens))
            th.start()
            return th

        def started(finished0):
            """Requests since ``finished0`` that hold or held a slot."""
            with core._lock:
                return (core.scheduler.num_running
                        + core.requests_finished_total - finished0)

        def running(n, finished0):
            deadline = time.time() + 120
            while started(finished0) < n and time.time() < deadline:
                time.sleep(0.002)
            if started(finished0) < n:
                raise AssertionError(f"{label}: {n} sequences never ran")

        # Concurrent: eight shorts together, then two longs together.
        finished0 = core.requests_finished_total
        threads = [start(i, _text(60 + i, 120), 96) for i in range(8)]
        running(8, finished0)
        threads += [start(8 + i, _text(70 + i, 2000), 8) for i in range(2)]
        for th in threads:
            th.join(timeout=600)
        steps_concurrent = core.step_recorder.recorded_total
        # One at a time: the serial shorts, then a long.
        finished0 = core.requests_finished_total
        threads = []
        for j in range(n_serial):
            prompt = (_text(80 + j, 120) if j < SERIAL_SHORTS
                      else _text(90, 2000))
            threads.append(start(10 + j, prompt,
                                 48 if j < SERIAL_SHORTS else 8))
            running(j + 1, finished0)
        for th in threads:
            th.join(timeout=600)
        for i, out in enumerate(outs):
            if out is None:
                raise AssertionError(f"{label}: request {i} got no reply")
            _finish(f"{label} {i}", out)
        steps_doc = json.loads(client.get("/debug/steps?limit=1024"))
        metrics = client.get("/metrics")
        launches = {name: getattr(fn, attr)
                    for name, (fn, attr) in counters.items()}
        now = core.stats()
        deltas = {k: now[k] - base[k] for k in (
            "deferred_prefill_tokens_total", "prefill_chunks_total",
            "fused_steps_total", "dispatch_count_total",
            "dispatch_enqueue_s", "decode_burst_count")}
        steps = [r for r in reversed(steps_doc["steps"])
                 if r["step"] > base_step]
        if len(steps) != steps_doc["recorded_total"] - base_step:
            raise AssertionError(f"{label}: the step ring lost records")
        # Step plans of the concurrent segment whose rows went as one
        # batched [rows, chunk] dispatch (alone, or as a fused step's leg).
        batched = {}
        for r in steps:
            if r["step"] <= steps_concurrent and r["batched"]:
                batched[r["kind"]] = batched.get(r["kind"], 0) + 1
        if not batched:
            raise AssertionError(f"{label}: no step plan of the concurrent "
                                 f"segment ran as a batched dispatch")
        summary = {
            "config": label,
            "run_s": time.time() - t_run,
            "deferred_prefill_tokens":
                deltas["deferred_prefill_tokens_total"],
            "prefill_chunks": deltas["prefill_chunks_total"],
            "long_latency_s": [o["_latency_s"] for o in outs[8:10]],
            "short_latency_s": [o["_latency_s"] for o in outs[:8]],
            "serial_latency_s": [o["_latency_s"] for o in outs[10:]],
            "batched_plans": batched,
            "recorder": recorder_summary(steps_doc, metrics, core),
            "fused_steps_scrape": metric_value(
                metrics, "tpu:fused_steps_total"),
            "launches": launches}
        kind_counts = core.stats()["step_kind_stats"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        core.stop()
    for name, n in launches.items():
        if name in entries and n <= 0:
            raise AssertionError(f"{name} never launched on the {label} "
                                 f"served path")
        if name not in entries and n != 0:
            raise AssertionError(f"{name} launched {n} times on the {label} "
                                 f"served path, which does not use it")
    texts = {"concurrent": [o["choices"][0]["text"] for o in outs[:10]],
             "serial": [o["choices"][0]["text"] for o in outs[10:]]}
    deltas["fused_recorded"] = kind_counts["fused"]["count"]
    return ({name: launches[name] for name in entries}, summary, texts,
            steps, deltas)


def metric_value(text: str, name: str):
    """The value of the first sample of ``name`` in ``/metrics`` text."""
    for line in text.splitlines():
        if line.startswith(name + "{"):
            return float(line.rsplit(" ", 1)[1])
    return None


def _step_dispatches(steps) -> dict:
    """The dispatches the run's step records account for, by kind: a
    fused step is one; a step plan one a forward (its rows share one
    batched dispatch, or go one a dispatch); a decode burst one."""
    out = {}
    for r in steps:
        n = 1 if r["kind"] in ("fused", "decode_burst") else r["forwards"]
        out[r["kind"]] = out.get(r["kind"], 0) + n
    return out


def _mean_wall(steps, kind):
    walls = [r["wall_s"] for r in steps if r["kind"] == kind]
    return sum(walls) / len(walls) if walls else None


def chunked_phase(entries):
    """The chunked-prefill serve of :func:`_chunked_serve`: step plans
    must alternate with decode bursts and defer tokens. Returns (launch
    counts by kernel entry, summary, (texts, step records, deltas))."""
    counts, summary, texts, steps, deltas = _chunked_serve(
        "bf16, chunked prefill (512-token steps)", [], entries)
    order = [r["kind"] for r in steps]
    chunk_steps = [i for i, k in enumerate(order) if k == "prefill_chunk"]
    if not chunk_steps:
        raise AssertionError("no chunked-prefill step plan ran")
    interleaved = sum(1 for k in order[chunk_steps[0]:chunk_steps[-1]]
                      if k == "decode_burst")
    if interleaved <= 0:
        raise AssertionError("no decode burst ran between the chunks")
    if summary["deferred_prefill_tokens"] <= 0:
        raise AssertionError("the step budget deferred no tokens")
    if deltas["fused_steps_total"] != 0:
        raise AssertionError("the alternating schedule took a fused step")
    summary.update(prefill_chunk_steps=len(chunk_steps),
                   decode_bursts_between_chunks=interleaved)
    return counts, summary, (texts, steps, deltas)


def fused_phase(entries, chunked):
    """The twin of :func:`chunked_phase` with ``--fused-step``: the same
    model, depth, arguments and prompts, each step plan launched with the
    decode burst as ONE dispatch while sequences run. The greedy texts of
    its one-at-a-time segment must equal the chunked phase's
    (``chunked``: its texts, step records and stats deltas; the
    concurrent segment's equal texts are counted), it must take fused
    steps, the recorder's "fused"
    count must equal ``fused_steps_total``, every dispatch of both runs
    must be accounted for by their step records (a fused step one, a
    step plan and a decode burst one each), and both kernels must
    launch. Returns (launch counts by kernel entry, summary)."""
    want_texts, alt_steps, alt = chunked
    counts, summary, texts, steps, deltas = _chunked_serve(
        "bf16, chunked prefill (512-token steps), --fused-step",
        ["--fused-step"], entries)
    if deltas["fused_steps_total"] < 1:
        raise AssertionError("the fused phase took no fused step")
    if deltas["fused_recorded"] != deltas["fused_steps_total"]:
        raise AssertionError(
            f"the recorder counts {deltas['fused_recorded']} fused steps, "
            f"the engine {deltas['fused_steps_total']}")
    if summary["fused_steps_scrape"] != deltas["fused_steps_total"]:
        raise AssertionError("/metrics: tpu:fused_steps_total is "
                             f"{summary['fused_steps_scrape']}")
    by_kind = {"fused": _step_dispatches(steps),
               "alternating": _step_dispatches(alt_steps)}
    for name, d, got in (("fused", by_kind["fused"], deltas),
                         ("alternating", by_kind["alternating"], alt)):
        if sum(d.values()) != got["dispatch_count_total"]:
            raise AssertionError(
                f"{name}: {got['dispatch_count_total']} dispatches, the "
                f"step records account for {d}")
    fused_records = sum(1 for r in steps if r["kind"] == "fused")
    if by_kind["fused"].get("fused", 0) != fused_records:
        raise AssertionError("a fused step took more than one dispatch")
    same = [a == b for a, b in zip(texts["serial"], want_texts["serial"])]
    if len(same) != SERIAL_SHORTS + 1 or not all(same):
        raise AssertionError(
            f"the one-at-a-time segment's fused streams differ from the "
            f"chunked phase's: equal {same}")
    # Concurrent arrivals batch by timing, so a request's prefill shapes,
    # and so its bf16 bits, may differ between the two runs: reported.
    same_concurrent = sum(a == b for a, b in zip(
        texts["concurrent"], want_texts["concurrent"]))
    alt_pair = ((_mean_wall(alt_steps, "prefill_chunk") or 0.0)
                + (_mean_wall(alt_steps, "decode_burst") or 0.0))
    summary.update(
        fused_steps=deltas["fused_steps_total"],
        fused_recorded=deltas["fused_recorded"],
        streams_equal_chunked=len(same),
        concurrent_streams_equal_chunked=same_concurrent,
        dispatches=deltas["dispatch_count_total"],
        dispatches_chunked=alt["dispatch_count_total"],
        dispatches_by_kind=by_kind,
        dispatches_per_pair={"fused": 1, "alternating": 2},
        dispatch_enqueue_s=deltas["dispatch_enqueue_s"],
        dispatch_enqueue_s_chunked=alt["dispatch_enqueue_s"],
        fused_step_wall_ms=1e3 * _mean_wall(steps, "fused"),
        alternating_pair_wall_ms=1e3 * alt_pair,
        prefill_chunk_wall_ms_chunked=1e3 * (
            _mean_wall(alt_steps, "prefill_chunk") or 0.0),
        decode_burst_wall_ms_chunked=1e3 * (
            _mean_wall(alt_steps, "decode_burst") or 0.0))
    return counts, summary


# -- speech to text: Whisper and the ASR server -----------------------------

ASR_MODEL = "whisper-small"  # full width: d 768, 12 + 12 layers, 12 heads
ASR_DEVICE = "cuda"
ASR_MAX_TOKENS = 64
ASR_CLIPS = ((30.0, 440.0, 1), (5.0, 220.0, 2))  # seconds, tone Hz, seed
ASR_FORMATS = ("json", "text", "verbose_json")
ASR_F32_TOKENS = 16
# float32 on the card against the same weights on the host, absolute:
# both run float32 products (no TF32: the port flips no global flag and
# computes its convolutions as plain products), so the two differ only
# in summation order. On an H100 against its host CPU that measured
# 4.7e-6 on the encoder states (max |x| 5.13) and 2.7e-6 on the logits;
# TF32 products round at ~5e-4 relative, ~1e-3 on such states. The bar
# sits between, and the phase checks that a TF32 run of the card fails
# it (its control).
ASR_F32_TOL = 5e-5
ASR_BODY_LIMIT = 64 * 1024 * 1024


def _asr_wav(seconds: float, freq: float, seed: int) -> bytes:
    """A 16 kHz mono 16-bit WAV: a tone plus seeded noise."""
    import io
    import wave

    import numpy as np

    n = int(16000 * seconds)
    t = np.arange(n) / 16000.0
    noise = np.random.default_rng(seed).normal(0, 0.05, n)
    pcm = ((0.3 * np.sin(2 * np.pi * freq * t) + noise)
           * 32767).clip(-32768, 32767).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def _asr_post(base: str, fields):
    """POST a multipart form (``fields``: (name, value[, filename])) to
    ``/v1/audio/transcriptions``: (status, content type, body bytes,
    seconds)."""
    import urllib.error
    import urllib.request

    boundary = "chip-smoke-asr"
    body = b""
    for name, value, *rest in fields:
        disp = f'form-data; name="{name}"'
        if rest:
            disp += f'; filename="{rest[0]}"'
        head = f"--{boundary}\r\nContent-Disposition: {disp}\r\n\r\n"
        body += head.encode() + (value if isinstance(value, bytes)
                                 else value.encode()) + b"\r\n"
    body += f"--{boundary}--\r\n".encode()
    req = urllib.request.Request(
        base + "/v1/audio/transcriptions", data=body, headers={
            "Content-Type": f"multipart/form-data; boundary={boundary}"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            out = (resp.status, resp.headers["Content-Type"], resp.read())
    except urllib.error.HTTPError as e:
        out = (e.code, e.headers["Content-Type"], e.read())
    return out + (time.perf_counter() - t0,)


def _whisper_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _whisper_leaves(v, f"{prefix}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _whisper_leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def whisper_encoder_flops(params, cfg) -> int:
    """Operations of one 30 s window's encoder pass: both convolutions,
    and a layer's four projections, two attention products over all
    1,500 positions and the FFN (its width read from the weights)."""
    T, d = cfg.n_audio_ctx, cfg.d_model
    ffn = params["enc_blocks"][0]["fc1"].shape[1]
    convs = 2 * 3 * (2 * T * cfg.n_mels * d + T * d * d)
    layer = 2 * T * (4 * d * d + 2 * T * d + 2 * d * ffn)
    return convs + cfg.encoder_layers * layer


def whisper_token_bytes(params, cfg) -> int:
    """Bytes one greedy decoder step must read: every decoder weight but
    the cross-attention K/V projections (run once a request), the tied
    embedding (the logits), and the cached cross K/V over the 1,500
    encoder positions."""
    skip = ("xk", "xv", "xv_b")
    blocks = sum(t.numel() * t.element_size()
                 for blk in params["dec_blocks"]
                 for k, t in blk.items() if k not in skip)
    emb = params["tok_emb"]
    kv = (2 * cfg.decoder_layers * cfg.n_audio_ctx * cfg.d_model
          * emb.element_size())
    return blocks + emb.numel() * emb.element_size() + kv


def asr_phase(smi: str, here: str) -> dict:
    """Whisper on the card (``ASR_MODEL`` at full width, random weights
    from seed 0, bf16) served by the port's ASR server
    (``engine/asr_server.py``) over HTTP: a 30 s and a 5 s synthetic WAV
    (tone plus seeded noise) in each response format, the 400 cases and
    a 413; ``/metrics`` must count every served request and second of
    audio. Then float32 on the card against the same weights on the host
    (encoder states and the first step's logits within ``ASR_F32_TOL``,
    which a TF32 run of the card must fail, ``ASR_F32_TOKENS`` greedy
    tokens equal), and a checkpoint of the
    served weights written by the port's writer and read back with
    ``load_whisper_checkpoint``: leaves bit-equal, the same tokens.
    Times: the host's mel frontend, the encoder (card synchronized), a
    generated token, each request, beside the encoder's operation bound
    and a token's byte bound. Returns the ``{"asr": ...}`` summary."""
    import dataclasses
    import threading

    import torch

    from production_stack_tpu_torch.engine.asr_server import (
        ASRServer,
        build_asr_server,
    )
    from production_stack_tpu_torch.models import whisper as tw
    from production_stack_tpu_torch.models.weights import (
        load_whisper_checkpoint,
        save_whisper_checkpoint,
    )
    from production_stack_tpu_torch.probes.common import HBM_BYTES_PER_S

    def sync():
        if ASR_DEVICE != "cpu":
            torch.cuda.synchronize()

    t0 = time.time()
    asr = ASRServer(ASR_MODEL, seed=0, max_tokens=ASR_MAX_TOKENS,
                    device=ASR_DEVICE)
    sync()
    cfg, model = asr.cfg, asr.model
    weight_bytes = sum(t.numel() * t.element_size()
                       for _, t in _whisper_leaves(model.params))
    summary = {"model": ASR_MODEL, "card": smi, "dtype": cfg.dtype,
               "device": str(model.device), "init_s": time.time() - t0,
               "weight_bytes": weight_bytes,
               "d_model": cfg.d_model, "layers": [cfg.encoder_layers,
                                                  cfg.decoder_layers],
               "vocab": cfg.vocab_size}
    httpd = build_asr_server(asr, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    client = Client(httpd.server_address[1])
    base = client.base
    clips = {sec: _asr_wav(sec, hz, seed) for sec, hz, seed in ASR_CLIPS}

    def counters():
        text = client.get("/metrics")
        return (metric_value(text, "tpu:asr_requests_total"),
                metric_value(text, "tpu:asr_audio_seconds_total"),
                metric_value(text, "vllm:num_requests_running"),
                metric_value(text, "vllm:num_requests_waiting"))

    try:
        status, _, body, warm_s = _asr_post(base, [
            ("file", clips[5.0], "warm.wav")])
        if status != 200:
            raise AssertionError(f"asr warm-up: {status} {body[:200]!r}")
        before = counters()
        requests, texts = [], {}
        for sec, _hz, _seed in ASR_CLIPS:
            for fmt in ASR_FORMATS:
                status, ctype, body, secs = _asr_post(base, [
                    ("file", clips[sec], f"{sec:g}s.wav"),
                    ("model", ASR_MODEL), ("response_format", fmt)])
                if status != 200:
                    raise AssertionError(f"asr {sec:g} s {fmt}: {status} "
                                         f"{body[:200]!r}")
                if fmt == "text":
                    text = body.decode()
                    if not ctype.startswith("text/plain"):
                        raise AssertionError(f"asr text: {ctype}")
                else:
                    doc = json.loads(body)
                    text = doc["text"]
                    if fmt == "verbose_json" and (
                            doc["duration"] != sec or not doc["segments"]
                            or doc["segments"][0]["end"] != sec):
                        raise AssertionError(f"asr verbose_json: {doc}")
                texts.setdefault(sec, set()).add(text)
                requests.append({"seconds": sec, "format": fmt,
                                 "request_s": secs,
                                 "real_time_factor": secs / sec,
                                 "chars": len(text)})
        for sec, seen in texts.items():
            if len(seen) != 1 or not next(iter(seen)):
                raise AssertionError(f"asr {sec:g} s: the formats gave "
                                     f"{len(seen)} texts")
        refusals = {}
        for case, fields, want in (
                ("no_file", [("model", ASR_MODEL)], 400),
                ("model", [("file", clips[5.0], "a.wav"),
                           ("model", "whisper-large")], 400),
                ("format", [("file", clips[5.0], "a.wav"),
                            ("response_format", "srt")], 400),
                ("audio", [("file", b"RIFF not a wave", "a.wav")], 400),
                ("too_large", [("file", b"\0" * (ASR_BODY_LIMIT + 1),
                                "big.wav")], 413)):
            status, _, body, _ = _asr_post(base, fields)
            if status != want:
                raise AssertionError(f"asr {case}: {status}, not {want}")
            refusals[case] = status
        after = counters()
        served = len(ASR_CLIPS) * len(ASR_FORMATS)
        audio = len(ASR_FORMATS) * sum(c[0] for c in ASR_CLIPS)
        if (after[0] - before[0] != served
                or abs(after[1] - before[1] - audio) > 1e-3
                or after[2] != 0 or after[3] != 0):
            raise AssertionError(f"asr /metrics moved {before} -> {after}")
        models = json.loads(client.get("/v1/models"))
        if models["data"][0]["task"] != "transcription":
            raise AssertionError(f"asr /v1/models: {models}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    summary.update(warm_up_s=warm_s, requests=requests, refusals=refusals,
                   metrics={"requests": after[0] - before[0],
                            "audio_seconds": after[1] - before[1]})

    # Where a request's time goes: the host's mel frontend, the encoder
    # and a generated token (the card synchronized around each).
    pcm30 = tw.decode_wav_bytes(clips[30.0])
    mel_ms = []
    for _ in range(3):
        t = time.perf_counter()
        mel = tw.log_mel_spectrogram(pcm30)
        mel_ms.append(1e3 * (time.perf_counter() - t))
    enc = model.encode(mel)
    sync()
    enc_ms = []
    for _ in range(5):
        t = time.perf_counter()
        enc = model.encode(mel)
        sync()
        enc_ms.append(1e3 * (time.perf_counter() - t))
    t = time.perf_counter()
    kv = tw.cross_kv(model.params, enc)
    sync()
    cross_ms = 1e3 * (time.perf_counter() - t)
    del kv
    t = time.perf_counter()
    toks = model.generate(enc, asr.sot, eot=-1, max_tokens=ASR_MAX_TOKENS)
    sync()
    token_ms = 1e3 * (time.perf_counter() - t) / len(toks)
    flops = whisper_encoder_flops(model.params, cfg)
    tok_bytes = whisper_token_bytes(model.params, cfg)
    summary.update(
        mel_host_ms=min(mel_ms), encode_ms=min(enc_ms),
        encode_ms_all=enc_ms, cross_kv_ms=cross_ms,
        ms_per_token=token_ms, tokens_timed=len(toks),
        encoder_flops=flops,
        encoder_bound_ms=flops / 989e12 * 1e3, encoder_bound_by="operations",
        token_bytes=tok_bytes,
        token_bound_ms=tok_bytes / HBM_BYTES_PER_S * 1e3,
        token_bound_by="bytes")

    # float32: the card against the host on the same weights.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    host = tw.init_whisper_params(cfg32, 0, "cpu")
    m_host = tw.WhisperModel(cfg32, params=host, device="cpu")
    m_card = tw.WhisperModel(cfg32, params=tw.params_to(host, ASR_DEVICE),
                             device=ASR_DEVICE)
    mel5 = tw.log_mel_spectrogram(tw.decode_wav_bytes(clips[5.0]))
    enc_h, enc_c = m_host.encode(mel5), m_card.encode(mel5)
    enc_err = float((enc_c.cpu() - enc_h).abs().max())
    with torch.inference_mode():
        lg_h = tw.decoder_logits(host, cfg32, asr.sot, len(asr.sot),
                                 enc=enc_h)
        lg_c = tw.decoder_logits(m_card.params, cfg32, asr.sot,
                                 len(asr.sot), enc=enc_c)
    logit_err = float((lg_c.cpu() - lg_h).abs().max())
    tok_h = m_host.generate(enc_h, asr.sot, eot=-1,
                            max_tokens=ASR_F32_TOKENS)
    tok_c = m_card.generate(enc_c, asr.sot, eot=-1,
                            max_tokens=ASR_F32_TOKENS)
    if not (enc_err <= ASR_F32_TOL and logit_err <= ASR_F32_TOL):
        raise AssertionError(f"asr float32 card vs host: encoder {enc_err}, "
                             f"logits {logit_err} (bar {ASR_F32_TOL})")
    # The control: the card's float32 run with TF32 products (what a
    # module setting the matmul precision to "high" would give) must fail
    # the bar, or the bar could not see that regression (a CPU rehearsal,
    # ASR_DEVICE "cpu", has no TF32 and skips it).
    tf32 = None
    if ASR_DEVICE != "cpu":
        precision = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("high")
        try:
            enc_t = m_card.encode(mel5)
            with torch.inference_mode():
                lg_t = tw.decoder_logits(m_card.params, cfg32, asr.sot,
                                         len(asr.sot), enc=enc_t)
        finally:
            torch.set_float32_matmul_precision(precision)
        tf32 = {"encoder_max_abs_err":
                float((enc_t.cpu() - enc_h).abs().max()),
                "logits_max_abs_err": float((lg_t.cpu() - lg_h).abs().max())}
        if not tf32["encoder_max_abs_err"] > ASR_F32_TOL:
            raise AssertionError(f"asr float32 bar {ASR_F32_TOL} passes a "
                                 f"TF32 run: {tf32}")
    if tok_c != tok_h or len(tok_c) != ASR_F32_TOKENS:
        raise AssertionError(f"asr float32 tokens: card {tok_c}, host "
                             f"{tok_h}")
    summary["float32"] = {"encoder_max_abs_err": enc_err,
                          "logits_max_abs_err": logit_err,
                          "encoder_max_abs": float(enc_h.abs().max()),
                          "logits_max_abs": float(lg_h.abs().max()),
                          "tol": ASR_F32_TOL, "tokens": len(tok_c),
                          "tokens_equal": True,
                          "tf32_control": tf32}
    del m_card, m_host, host, enc_c

    # A checkpoint of the served weights, through the port's writer and
    # loader: bit for bit, and the same tokens.
    ckpt = os.path.join(here, "production_stack_tpu_torch", "_build",
                        "whisper-small-ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        t = time.perf_counter()
        written = save_whisper_checkpoint(model.params, cfg, ckpt)
        write_s = time.perf_counter() - t
        t = time.perf_counter()
        loaded = load_whisper_checkpoint(
            dataclasses.replace(tw.get_whisper_config(ckpt),
                                dtype=cfg.dtype), ckpt)
        read_s = time.perf_counter() - t
        want = dict(_whisper_leaves(model.params))
        got = dict(_whisper_leaves(loaded))
        if got.keys() != want.keys():
            raise AssertionError("asr checkpoint: other leaves")
        differ = [k for k in want
                  if not torch.equal(got[k], want[k].cpu())]
        if differ:
            raise AssertionError(f"asr checkpoint: leaves differ {differ[:4]}")
        m_ckpt = tw.WhisperModel(cfg, params=tw.params_to(loaded, ASR_DEVICE),
                                 device=ASR_DEVICE)
        pcm5 = tw.decode_wav_bytes(clips[5.0])
        kwargs = dict(sot=asr.sot, eot=asr.eot, max_tokens=ASR_F32_TOKENS)
        if (m_ckpt.transcribe_tokens(pcm5, **kwargs)
                != model.transcribe_tokens(pcm5, **kwargs)):
            raise AssertionError("asr checkpoint: other tokens")
        summary["checkpoint"] = {"bytes": written, "write_s": write_s,
                                 "read_s": read_s, "leaves": len(got),
                                 "bit_equal": True, "tokens_equal": True}
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    log(f"[asr] {json.dumps(summary)}")
    return summary


# -- structured output, n > 1 and tools ----------------------------------------

# The grammars of the structured serve phase's eight concurrent requests:
# (name, request fields, max_tokens, whether the language is finite). A
# finite language (an enum, a bounded regex) must be fullmatched with
# finish "stop"; an open one (free strings, integers) may end by length
# mid-structure, which counts one violation, as in the JAX engine.
# The structured runs' depth: Llama-3-8B's widths at 8 of its 32 layers
# (cut to pay for the fused and asr phases; their grammars, masks and
# kernels are the same at any depth).
STRUCTURED_LAYERS = 8
WEATHER_TOOL = {"type": "function", "function": {
    "name": "get_weather", "description": "Current weather for a city",
    "parameters": {"type": "object", "properties": {
        "city": {"type": "string"}}, "required": ["city"]}}}


def _grammar_requests():
    from production_stack_tpu_torch.structured.corpus import (
        case_request_fields,
        load_corpus,
    )

    cases = {c["name"]: c for c in load_corpus()}
    return [
        ("guided_json schema-object-two-required", case_request_fields(
            cases["schema-object-two-required"], "guided"), 48, False),
        ("response_format schema-object-one-required", case_request_fields(
            cases["schema-object-one-required"], "response_format"), 32,
         False),
        ("guided_regex [ab]{3}", {"guided_regex": "[ab]{3}"}, 16, True),
        ("guided_json enum", {"guided_json": {
            "enum": ["red", "green", "blue"]}}, 16, True),
        ("guided_regex (yes|no|maybe), prefix hit",
         {"guided_regex": "(yes|no|maybe)"}, 8, True),
    ]


def _grammar_check(name, fields, finite, out):
    """(text, whether it counts a violation): the text must keep the
    automaton alive; a finite language's must be a whole member ending
    in "stop"; an open one's ending by length mid-structure counts a
    violation (the engine's count is held to these)."""
    from production_stack_tpu_torch.structured.api import (
        compile_char_dfa,
        parse_structured,
    )

    finish = _finish(name, out)
    text = out["choices"][0]["text"]
    dfa = compile_char_dfa(parse_structured(fields))
    if dfa.walk(0, text) < 0:
        raise AssertionError(f"{name}: {text!r} leaves its grammar")
    whole = dfa.fullmatch(text)
    if finite and not (whole and finish == "stop"):
        raise AssertionError(f"{name}: {text!r} ({finish}) is not a whole "
                             f"member of its finite language")
    if finish == "stop" and not whole:
        raise AssertionError(f"{name}: stopped mid-structure: {text!r}")
    return text, finish == "length" and not whole


def mask_costs(core, texts_by_fields) -> dict:
    """The mask term's costs at the served vocabulary. Host: a fresh
    ``TokenFSM`` over the engine's token table materialises the mask row
    of every state each served text walks through (``mask_row``, timed
    on the host clock; the engine does the same once per state and
    schema). Device: ``apply_fsm_mask`` on ``[8, V]`` float32 logits
    (a prefill's first token, a verify position), its unpacking alone
    (once a decode burst) and the masking alone (each burst step)."""
    import torch

    from production_stack_tpu_torch.engine.sampling import (
        apply_fsm_mask,
        fsm_allowed,
        mask_disallowed,
    )
    from production_stack_tpu_torch.probes.timing import cuda_time_ms
    from production_stack_tpu_torch.structured.api import (
        compile_char_dfa,
        parse_structured,
    )
    from production_stack_tpu_torch.structured.tokenfsm import (
        TokenFSM,
        mask_row_bytes,
    )

    V = core.model_config.vocab_size
    table = core._structured_cache._token_table
    eos = core.tokenizer.eos_token_id
    per_request, seconds = [], []
    for fields, text in texts_by_fields:
        fsm = TokenFSM(compile_char_dfa(parse_structured(fields)), table,
                       eos, V)
        state, states = fsm.start, {fsm.start}
        for byte in text.encode("utf-8"):
            state = fsm.advance(state, byte)
            states.add(state)
        for st in sorted(states):
            t0 = time.perf_counter()
            fsm.mask_row(st)
            seconds.append(time.perf_counter() - t0)
        per_request.append(len(states))
    g = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn((8, V), generator=g, device="cuda")
    rows = torch.randint(0, 256, (8, mask_row_bytes(V)), generator=g,
                         device="cuda", dtype=torch.uint8)
    on = torch.ones((8,), dtype=torch.bool, device="cuda")
    allowed = fsm_allowed(rows, on, V)
    return {
        "vocab": V, "row_bytes": mask_row_bytes(V),
        "host_states_per_request": per_request,
        "host_s_per_state_mean": sum(seconds) / len(seconds),
        "host_s_per_state_max": max(seconds),
        "host_s_total": sum(seconds),
        "device_apply_ms": cuda_time_ms(
            lambda: apply_fsm_mask(logits, rows, on), iters=50),
        "device_unpack_ms": cuda_time_ms(
            lambda: fsm_allowed(rows, on, V), iters=50),
        "device_mask_ms": cuda_time_ms(
            lambda: mask_disallowed(logits, allowed), iters=50)}


def _sse_choices(client, path, body):
    """A streamed response's chunks: [(index, delta or text, finish)]."""
    import urllib.request

    req = urllib.request.Request(
        client.base + path, data=json.dumps(dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    chunks = []
    with urllib.request.urlopen(req, timeout=600) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            c = json.loads(line[6:])["choices"][0]
            piece = c.get("text")
            if piece is None:
                piece = c.get("delta", {}).get("content") or ""
            chunks.append((c["index"], piece, c.get("finish_reason")))
    return chunks


def surface_drive(client) -> dict:
    """``n = 4`` and ``tools`` through the server: the seeded ``n = 4``
    completion has four choices, choice ``i`` the text of a single
    request under seed ``base + i`` (the singles sent together, so that
    they share a decode batch as the choices did; the prompt is shorter
    than a page, so no run hits the prefix cache); its streamed form
    carries every index; a chat with ``tools`` returns a well-formed
    message (random weights emit no call)."""
    import threading

    base_seed = 500
    body = {"prompt": _text(220, 40), "n": 4, "max_tokens": 16,
            "temperature": 0.8, "seed": base_seed}
    out = client.post("/v1/completions", body)
    choices = out["choices"]
    if [c["index"] for c in choices] != [0, 1, 2, 3]:
        raise AssertionError(f"n=4: choices {choices}")
    for c in choices:
        if c["finish_reason"] not in ("stop", "length"):
            raise AssertionError(f"n=4: finish {c['finish_reason']!r}")
    singles = [None] * 4

    def single(i):
        singles[i] = client.post("/v1/completions", dict(
            body, n=1, seed=base_seed + i))

    threads = [threading.Thread(target=single, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    equal = [s is not None and s["choices"][0]["text"] == c["text"]
             for s, c in zip(singles, choices)]
    if not all(equal):
        raise AssertionError(f"n=4: choices equal to single requests under "
                             f"seed base + i: {equal}")
    chunks = _sse_choices(client, "/v1/completions", body)
    indices = sorted({i for i, _, _ in chunks})
    finishes = [f for _, _, f in chunks if f]
    if indices != [0, 1, 2, 3] or len(finishes) != 4:
        raise AssertionError(f"n=4 streamed: indices {indices}, finishes "
                             f"{finishes}")
    tools = client.post("/v1/chat/completions", {
        "messages": [{"role": "user", "content": "weather in Paris?"}],
        "tools": [WEATHER_TOOL], "max_tokens": 16, "temperature": 0})
    msg = tools["choices"][0]["message"]
    finish = tools["choices"][0]["finish_reason"]
    if msg.get("role") != "assistant" or finish not in (
            "stop", "length", "tool_calls") or not (
            isinstance(msg.get("content"), str) or msg.get("tool_calls")):
        raise AssertionError(f"tools: malformed reply {tools['choices']}")
    return {"n4_texts_equal_singles": equal,
            "n4_usage": out["usage"], "n4_stream_indices": indices,
            "tools_finish": finish,
            "tools_prompt_tokens": tools["usage"]["prompt_tokens"],
            "tools_calls": len(msg.get("tool_calls") or [])}


def structured_phase(label: str, extra_args, entries, surface: bool,
                     model: str):
    """Serve Llama-3-8B (``SERVE_ARGS`` plus ``extra_args``, with
    ``model``, a local directory of :func:`llama_8b_dir`, in its place) and send
    eight requests at once: the grammars of :func:`_grammar_requests`
    (one on a prompt that hits the prefix cache, the enum on a
    ~2,000-token prompt) beside three unconstrained ones (two more
    ~2,000-token prompts, so that the long prompts may arrive as a
    storm); then a plain and a structured request alone each, for the
    decode forwards a generated token costs each (a structured row uses
    one step of each burst); with ``surface``, :func:`surface_drive`.
    Counters as in :func:`serve_phase`. Every grammar is held by
    :func:`_grammar_check`, and the engine's violation count to the
    texts'. Returns (launch counts by kernel entry, summary)."""
    import threading

    import torch

    from production_stack_tpu_torch.engine.server import build_server

    grammars = _grammar_requests()
    warm = _text(96, 1100)
    t0 = time.time()
    httpd, core = build_server([model] + SERVE_ARGS[1:]
                               + list(extra_args))
    torch.cuda.synchronize()
    init_s = time.time() - t0
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    client = Client(httpd.server_address[1])
    try:
        _finish("warm-up", client.post("/v1/completions", {
            "prompt": warm, "max_tokens": 9, "temperature": 0}))
        base = core.stats()
        counters = _counters()
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        t_run = time.time()
        prompts = [_text(200, 300), _text(201, 300), _text(202, 100),
                   _text(203, 2000), warm + _text(204, 200),
                   _text(205, 2000), _text(206, 1800), _text(207, 200)]
        bodies = [dict(fields, prompt=prompts[i], max_tokens=mt,
                       temperature=0)
                  for i, (_n, fields, mt, _f) in enumerate(grammars)]
        bodies += [{"prompt": prompts[5], "max_tokens": 16,
                    "temperature": 0},
                   {"prompt": prompts[6], "max_tokens": 16,
                    "temperature": 0},
                   {"prompt": prompts[7], "max_tokens": 64,
                    "temperature": 0.8, "seed": 9}]
        outs = [None] * len(bodies)

        def run(i):
            outs[i] = client.post("/v1/completions", bodies[i])

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(bodies))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        for i, out in enumerate(outs):
            if out is None:
                raise AssertionError(f"structured request {i} got no reply")
        checked = [_grammar_check(name, fields, finite, outs[i])
                   for i, (name, fields, _mt, finite) in enumerate(grammars)]
        for i in range(len(grammars), len(bodies)):
            _finish(f"unconstrained {i}", outs[i])
        mid = core.stats()
        # The decode forwards a token costs, plain and structured, each
        # request alone (32 tokens; the grammar's 32nd is EOS).
        alone = {}
        for kind, body in (
                ("plain", {"prompt": _text(210, 40), "max_tokens": 32,
                           "temperature": 0, "ignore_eos": True}),
                ("structured", {"prompt": _text(210, 40), "max_tokens": 40,
                                "temperature": 0,
                                "guided_regex": "[a-z ]{31}"})):
            before = core.stats()
            t_req = time.perf_counter()
            out = client.post("/v1/completions", body)
            wall = time.perf_counter() - t_req
            _finish(kind, out)
            after = core.stats()
            gen = (after["generation_tokens_total"]
                   - before["generation_tokens_total"])
            fwd = (after["decode_forward_steps_total"]
                   - before["decode_forward_steps_total"])
            # The engine counts the decode bursts' tokens (the first token
            # comes from the prefill).
            alone[kind] = {"decode_tokens": gen, "decode_forwards": fwd,
                           "decode_forwards_per_token": fwd / max(gen, 1),
                           "request_s": wall}
        if alone["structured"]["decode_tokens"] != 31:
            raise AssertionError(f"the structured request alone decoded "
                                 f"{alone['structured']['decode_tokens']} "
                                 f"tokens")
        surface = surface_drive(client) if surface else None
        metrics = client.get("/metrics")
        launches = {name: getattr(fn, attr)
                    for name, (fn, attr) in counters.items()}
        now = core.stats()
        costs = mask_costs(core, [(fields, text) for (_n, fields, _m, _f),
                                  (text, _v) in zip(grammars, checked)])
    finally:
        httpd.shutdown()
        httpd.server_close()
        core.stop()
    d = {k: mid[k] - base[k] for k in (
        "structured_requests_total", "structured_violations_total",
        "structured_mask_states_total", "structured_compile_seconds_total",
        "prefix_cache_hits", "prefill_batched_dispatch_total",
        "prefill_group_count", "decode_forward_steps_total",
        "generation_tokens_total")}
    want_violations = sum(v for _t, v in checked)
    if d["structured_requests_total"] != len(grammars):
        raise AssertionError(f"structured requests {d}")
    if d["structured_violations_total"] != want_violations:
        raise AssertionError(
            f"structured_violations_total moved by "
            f"{d['structured_violations_total']}, the texts show "
            f"{want_violations} (length caps mid-structure)")
    if d["prefix_cache_hits"] <= 0:
        raise AssertionError("the prefix-hit grammar request hit no cache")
    series = [line for line in metrics.splitlines()
              if line.startswith("tpu:structured_")]
    for family in ("requests", "compile_seconds", "mask_states",
                   "violations"):
        if not any(line.startswith(f"tpu:structured_{family}_total{{")
                   for line in series):
            raise AssertionError(f"/metrics lacks tpu:structured_{family}")
    for name, n in launches.items():
        if name in entries and n <= 0:
            raise AssertionError(f"{name} never launched on the structured "
                                 f"{label} served path")
        if name not in entries and n != 0:
            raise AssertionError(f"{name} launched {n} times on the "
                                 f"structured {label} served path")
    summary = dict(
        config=label, init_s=init_s, run_s=time.time() - t_run,
        requests=len(bodies), **d,
        structured_violations_from_length_caps=want_violations,
        texts={name: (text[:48], out["choices"][0]["finish_reason"])
               for (name, *_r), (text, _v), out in zip(
                   grammars, checked, outs)},
        alone=alone,
        decode_forwards_per_token_structured_vs_plain=(
            alone["structured"]["decode_forwards_per_token"]
            / alone["plain"]["decode_forwards_per_token"]),
        mask=costs, surface=surface, series=series,
        launches={k: v for k, v in launches.items() if v})
    return {name: launches[name] for name in entries}, summary


# Speculative decoding at --speculative-num-tokens 4: prompt lookup, then
# Llama-3-8B drafting for itself (the same seed gives the same weights).
SPEC_ARGS = ["--speculative-num-tokens", "4"]
SPEC_RUNS = (("ngram", SPEC_ARGS),
             ("self-drafter", SPEC_ARGS + ["--speculative-draft-model"]))
# The spec phases serve Llama-3-8B's widths at this many of its 32 layers
# (the pp phase serves all 32): four engines' draws and drives.
SPEC_LAYERS = 8
SPEC_PHRASES = ("the pages of every layer stay resident on the card. ",
                "a verify burst scores four tokens in one forward. ",
                "drafts that match the samples are accepted in order. ",
                "rejected positions roll their pages back at the flush. ")
SPEC_SERIES = ("tpu:spec_proposed_tokens_total",
               "tpu:spec_accepted_tokens_total",
               "tpu:spec_acceptance_rate", "tpu:spec_disabled_requests_total",
               "tpu:spec_verify_bursts_total",
               "tpu:spec_draft_forward_steps_total")
# The self-drafter's acceptance below which the phase fails.
SELF_DRAFT_ACCEPTANCE = 0.5


def _spec_prompts():
    """Four prompts that repeat a phrase (~1,000 tokens) and four of
    :func:`_text`."""
    reps = [(p * (1000 // len(p) + 1))[:1000] for p in SPEC_PHRASES]
    return reps + [_text(80 + i, 400) for i in range(4)]


def _spec_drive(client, prompts, core):
    """The eight prompts at once, greedy, 128 tokens each; then one seeded
    sampled request sent twice, alone each time. Returns (texts, the
    engine's stats between the two parts, the seeded pair's texts)."""
    import threading

    outs = [None] * len(prompts)

    def run(i):
        outs[i] = client.post("/v1/completions", {
            "prompt": prompts[i], "max_tokens": 128, "temperature": 0,
            "ignore_eos": True})

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    for i, out in enumerate(outs):
        if out is None:
            raise AssertionError(f"spec request {i} got no reply")
        _finish(f"spec request {i}", out)
    between = core.stats()
    seeded = [client.post("/v1/completions", {
        "prompt": _text(51, 40), "max_tokens": 32, "temperature": 0.8,
        "seed": 4321}) for _ in range(2)]
    for out in seeded:
        _finish("spec seeded", out)
    return ([o["choices"][0]["text"] for o in outs], between,
            [o["choices"][0]["text"] for o in seeded])


# Two grammar requests added to each speculative run, at once after its
# drive: a finite language and a corpus schema (free strings).
SPEC_GRAMMARS = (
    ("guided_regex [a-z ]{24}", {"guided_regex": "[a-z ]{24}"}, 32, True),
    ("guided_json schema-object-two-required", {"guided_json": {
        "type": "object", "properties": {"name": {"type": "string"},
                                         "age": {"type": "integer"}},
        "required": ["name", "age"]}}, 64, False))


def _spec_grammar_drive(client, core):
    """The two ``SPEC_GRAMMARS`` requests at once (greedy, on a phrase
    prompt of the drive), each held by :func:`_grammar_check`. Returns
    (texts, the violations the texts show, the engine's stats before and
    after, the drafter's FSM-constrained draft forwards in between)."""
    import threading

    constrained = [0]
    wrapped = core._draft_constrained

    def counted(info, drafts, steps_max, W0):
        before = core.spec_draft_forward_steps_total
        wrapped(info, drafts, steps_max, W0)
        constrained[0] += core.spec_draft_forward_steps_total - before

    core._draft_constrained = counted
    before = core.stats()
    outs = [None] * len(SPEC_GRAMMARS)

    def run(i):
        _name, fields, max_tokens, _finite = SPEC_GRAMMARS[i]
        outs[i] = client.post("/v1/completions", dict(
            fields, prompt=SPEC_PHRASES[i] * 8, max_tokens=max_tokens,
            temperature=0))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(SPEC_GRAMMARS))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    try:
        checked = []
        for i, (name, fields, _mt, finite) in enumerate(SPEC_GRAMMARS):
            if outs[i] is None:
                raise AssertionError(f"spec grammar request {i} got no "
                                     f"reply")
            checked.append(_grammar_check(name, fields, finite, outs[i]))
    finally:
        core._draft_constrained = wrapped
    return ([t for t, _v in checked], sum(v for _t, v in checked), before,
            core.stats(), constrained[0])


def llama_8b_dir(here: str, layers: int) -> str:
    """A local model directory holding Llama-3-8B's config.json at
    ``layers`` of its 32 layers (full width; no weights: the server draws
    them from its seed), under the kernels' git-ignored build directory.
    Its ``tokenizer_config.json`` names a tokenizer class that
    ``transformers`` does not have, so the engine falls back to its byte
    tokenizer, as it does for the registry name (a ``transformers`` that
    builds a Llama tokenizer with no vocabulary files from a bare
    config.json would otherwise serve an empty vocabulary, and grammars
    would allow no token)."""
    from production_stack_tpu_torch.models import get_model_config
    from production_stack_tpu_torch.models.weights import hf_config

    path = os.path.join(here, "production_stack_tpu_torch", "_build",
                        "models", f"Llama-3-8B-{layers}L")
    os.makedirs(path, exist_ok=True)
    cfg = get_model_config("meta-llama/Llama-3-8B").replace(
        num_layers=layers, dtype="bfloat16")
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config(cfg), f, indent=1)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "NoTokenizerFilesHere"}, f)
    return path


def spec_phase(smi, here):
    """Serve Llama-3-8B (``SPEC_LAYERS`` of its layers) in bf16 four
    times on the same requests
    (:func:`_spec_drive`): plain, then with prompt-lookup speculation,
    then drafting for itself. Counters as in :func:`serve_phase`, around
    each speculative drive, which ends with the two grammar requests of
    :func:`_spec_grammar_drive`. Prints a ``{"spec": ...}`` line a run
    and returns the launch counts of the two speculative runs summed and
    of the self-drafting run, by kernel entry. Fails when a speculative
    run has no verify burst, a request errors, the self-drafter's
    acceptance is below ``SELF_DRAFT_ACCEPTANCE``, it ran no
    FSM-constrained draft step, a grammar text is empty or leaves its
    grammar, the violation count differs from the texts' or a seeded
    pair gives two texts."""
    import threading

    import torch

    from production_stack_tpu_torch.engine.server import build_server

    prompts = _spec_prompts()
    plain_tpf = plain_greedy_tpf = plain_texts = None
    total, drafter = {}, {}
    model = llama_8b_dir(here, SPEC_LAYERS)
    args = [model] + SERVE_ARGS[1:]
    # The plain run twice: greedy bf16 texts of random weights may part
    # between two runs of one engine (arrival order changes which prompts
    # share a batched prefill), which is what the speculative runs' text
    # comparisons are read against.
    for label, extra in (("plain", []), ("plain again", [])) + SPEC_RUNS:
        _free_device_memory()
        if label == "self-drafter":
            extra = list(extra) + [model]  # the same seed: its own weights
        t0 = time.time()
        httpd, core = build_server(args + list(extra))
        torch.cuda.synchronize()
        init_s = time.time() - t0
        if type(core.tokenizer).__name__ != "ByteTokenizer":
            raise AssertionError(f"spec {label}: {model} serves "
                                 f"{type(core.tokenizer).__name__}, not "
                                 f"the byte tokenizer")
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        client = Client(httpd.server_address[1])
        try:
            _finish("warm-up", client.post("/v1/completions", {
                "prompt": _text(97, 1100), "max_tokens": 9,
                "temperature": 0}))
            base = core.stats()
            rec_base = core.step_recorder.kind_stats()["spec_verify"]
            counters = _counters()
            for fn, attr in counters.values():
                setattr(fn, attr, 0)
            t_run = time.time()
            texts, between, seeded = _spec_drive(client, prompts, core)
            (g_texts, g_violations, g_before, g_after,
             g_constrained) = _spec_grammar_drive(client, core)
            run_s = time.time() - t_run
            launches = {name: getattr(fn, attr)
                        for name, (fn, attr) in counters.items()}
            metrics = client.get("/metrics")
            # The drive's own counts stop before the grammar requests.
            now = g_before
            rec = core.step_recorder.kind_stats()["spec_verify"]
            layers = core.model_config.num_layers
        finally:
            httpd.shutdown()
            httpd.server_close()
            core.stop()
        if seeded[0] != seeded[1]:
            raise AssertionError(f"spec {label}: a seeded sampled request "
                                 f"gave two texts")
        d = {k: now[k] - base[k] for k in (
            "generation_tokens_total", "decode_forward_steps_total",
            "spec_verify_bursts_total", "spec_proposed_tokens_total",
            "spec_accepted_tokens_total", "spec_draft_forward_steps_total",
            "spec_disabled_requests_total", "decode_burst_count")}
        by_source = {key: {src: now[key][src] - base[key][src]
                           for src in now[key]}
                     for key in ("spec_proposed_by_source",
                                 "spec_accepted_by_source")}
        tpf = (d["generation_tokens_total"]
               / max(d["decode_forward_steps_total"], 1))
        # The same over the eight greedy requests alone.
        greedy_tpf = ((between["generation_tokens_total"]
                       - base["generation_tokens_total"])
                      / max(between["decode_forward_steps_total"]
                            - base["decode_forward_steps_total"], 1))
        g = {k: g_after[k] - g_before[k] for k in (
            "spec_proposed_tokens_total", "spec_accepted_tokens_total",
            "spec_verify_bursts_total", "spec_draft_forward_steps_total",
            "structured_violations_total", "generation_tokens_total",
            "decode_forward_steps_total")}
        if g["structured_violations_total"] != g_violations:
            raise AssertionError(
                f"spec {label}: structured_violations_total moved by "
                f"{g['structured_violations_total']}, the grammar texts "
                f"show {g_violations} (length caps mid-structure)")
        if not all(g_texts):
            raise AssertionError(f"spec {label}: an empty grammar text")
        grammar = dict(
            g, texts=[t[:48] for t in g_texts],
            violations_from_length_caps=g_violations,
            acceptance=(g["spec_accepted_tokens_total"]
                        / g["spec_proposed_tokens_total"]
                        if g["spec_proposed_tokens_total"] else None),
            constrained_draft_forwards=g_constrained)
        summary = dict(
            config=f"bf16, {label}", layers=layers, card=smi,
            init_s=init_s, run_s=run_s,
            requests=len(prompts) + 2 + len(SPEC_GRAMMARS), **d, **by_source,
            grammar=grammar,
            tokens_per_target_forward=tpf,
            greedy_tokens_per_target_forward=greedy_tpf,
            launches={k: v for k, v in launches.items() if v},
            # Every verify of the run, the grammar requests' included.
            verify_launches=(d["spec_verify_bursts_total"]
                             + g["spec_verify_bursts_total"]) * layers,
            sample_text=texts[0][:40])
        if label == "plain":
            plain_tpf, plain_greedy_tpf, plain_texts = tpf, greedy_tpf, texts
        else:
            # Informational: bf16 greedy texts may part from the first
            # plain run's at a near-tie.
            summary["greedy_texts_equal_to_plain"] = sum(
                a == b for a, b in zip(texts, plain_texts))
            summary["first_difference_chars"] = [
                next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b))) if a != b else None
                for a, b in zip(texts, plain_texts)]
        if extra:  # a speculative run
            proposed = d["spec_proposed_tokens_total"]
            greedy_proposed = (between["spec_proposed_tokens_total"]
                               - base["spec_proposed_tokens_total"])
            summary.update(
                acceptance=(d["spec_accepted_tokens_total"] / proposed
                            if proposed else 0.0),
                # The eight greedy requests alone (the seeded pair samples
                # at 0.8, which a greedy drafter rarely matches).
                greedy_acceptance=(
                    (between["spec_accepted_tokens_total"]
                     - base["spec_accepted_tokens_total"]) / greedy_proposed
                    if greedy_proposed else 0.0),

                tokens_per_target_forward_vs_plain=tpf / plain_tpf,
                greedy_tokens_per_target_forward_vs_plain=(
                    greedy_tpf / plain_greedy_tpf),
                recorder_spec_verify={k: rec[k] - rec_base[k] for k in rec},
                metrics=[line for line in metrics.splitlines()
                         if line.startswith("tpu:spec_")])
            missing = [m for m in SPEC_SERIES if m not in metrics]
            if missing:
                raise AssertionError(f"spec {label}: /metrics lacks "
                                     f"{missing}")
            if d["spec_verify_bursts_total"] <= 0:
                raise AssertionError(f"spec {label}: no verify burst ran")
            n_verify = (d["spec_verify_bursts_total"]
                        + g["spec_verify_bursts_total"])
            if summary["recorder_spec_verify"]["count"] != n_verify:
                raise AssertionError(f"spec {label}: the recorder kept "
                                     f"{summary['recorder_spec_verify']} "
                                     f"for {n_verify} verify bursts")
            for name, n in launches.items():
                on_path = name in ("paged_attention",
                                   "cached_prefill_attention")
                if on_path and n <= 0:
                    raise AssertionError(f"{name} never launched on the "
                                         f"spec {label} served path")
                if not on_path and n != 0:
                    raise AssertionError(f"{name} launched {n} times on "
                                         f"the spec {label} served path")
                if on_path:
                    total[name] = total.get(name, 0) + n
            if label == "self-drafter":
                drafter = launches
            if launches["cached_prefill_attention"] < summary[
                    "verify_launches"]:
                raise AssertionError(f"spec {label}: fewer cached-prefill "
                                     f"launches than verify layers")
            if label == "self-drafter" and g_constrained <= 0:
                raise AssertionError("spec self-drafter: no FSM-constrained "
                                     "draft step ran")
            if label == "self-drafter" and (
                    summary["acceptance"] < SELF_DRAFT_ACCEPTANCE):
                raise AssertionError(
                    f"spec self-drafter: acceptance "
                    f"{summary['acceptance']:.3f} below "
                    f"{SELF_DRAFT_ACCEPTANCE}")
        log(f"[spec] {json.dumps(summary)}")
        print(json.dumps({"spec": summary}), flush=True)
    _free_device_memory()
    return total, drafter


# The card's float32 check of the whole speculative path: each model's
# streams with each proposer equal to plain decode's, token for token
# (tiny-llama: D 32, 4/2 heads; tpu-llama-1b: D 128, 16/8 heads).
SPEC_PARITY_MODELS = ("tiny-llama", "tpu-llama-1b")
SPEC_PARITY_CFG = dict(device="cuda", dtype="float32", max_model_len=256,
                       max_num_seqs=2, block_size=8, num_blocks=64,
                       min_prefill_bucket=16, max_loras=0)


def spec_parity_phase(smi):
    """``SPEC_PARITY_MODELS`` at float32 on the card (the kernels' f32
    mode): the reference's spec requests (repetitive greedy prompts, a
    prompt with no repeats, a tight pool's preemption, seeded sampled
    rows on two tokens) through a plain engine, a prompt-lookup engine
    and a self-drafting one; every stream must equal the plain engine's,
    each speculative engine must have run verify bursts and the greedy
    self-drafter must accept nine drafts in ten at least. Prints a
    ``{"spec_parity": ...}`` line."""
    import queue

    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.core import EngineCore
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.structured.api import parse_structured

    def greedy(n):
        return SamplingParams(max_tokens=n, temperature=0.0, ignore_eos=True)

    def sampled(seed, bias):
        return SamplingParams(max_tokens=24, temperature=0.8, seed=seed,
                              ignore_eos=True,
                              logit_bias={t: 100.0 for t in bias})

    def guided(n, **fields):
        return SamplingParams(max_tokens=n, temperature=0.0,
                              structured=parse_structured(fields))

    scenarios = {
        "greedy": ({}, [([5, 6, 7, 8] * 6, greedy(24)),
                        ([9, 10, 11] * 8, greedy(24)),
                        ([31, 7, 2, 19, 44, 3, 28, 11], greedy(24))]),
        "preempt": (dict(num_blocks=16),
                    [([5, 6, 7, 8] * 2, greedy(60)),
                     ([9, 10, 11, 12] * 12, greedy(60))]),
        "sampled": ({}, [([5, 6] * 10, sampled(11, (5, 6))),
                         ([7, 8, 9] * 6, sampled(12, (7, 8)))]),
        # Grammar rows: every sampling site masked, the self-drafter's
        # FSM-constrained draft steps on the cached-prefill kernel.
        "structured": ({}, [
            ([5, 6, 7, 8] * 6, guided(16, guided_json={
                "type": "object", "properties": {"n": {"type": "integer"}},
                "required": ["n"]})),
            ([31, 7, 2, 19, 44, 3, 28, 11],
             guided(16, guided_regex="[ab]{3}")),
            (list(b"abababab ab ab"), guided(24, guided_regex="(ab)+c"))]),
    }

    def run(model, over, reqs):
        eng = EngineCore(EngineConfig(model=model,
                                      **dict(SPEC_PARITY_CFG, **over)))
        eng.start()
        queues = []
        try:
            with eng._lock:
                for i, (prompt, sp) in enumerate(reqs):
                    q = queue.Queue()
                    eng.add_request(f"p{i}", list(prompt), sp,
                                    lambda t, f, q=q: q.put((t, f)))
                    queues.append(q)
            out = []
            for q in queues:
                tokens = []
                while True:
                    t, f = q.get(timeout=300)
                    if t is not None:
                        tokens.append(t)
                    if f is not None:
                        out.append((tokens, f))
                        break
        finally:
            eng.stop()
        return out, eng.stats()

    report = {"card": smi, "dtype": "float32"}
    for model in SPEC_PARITY_MODELS:
        for name, (over, reqs) in scenarios.items():
            want, _ = run(model, over, reqs)
            for label, spec in (
                    ("ngram", dict(speculative_num_tokens=4)),
                    ("self-drafter", dict(speculative_num_tokens=4,
                                          speculative_draft_model=model))):
                case = f"{model} {name} {label}"
                got, stats = run(model, dict(over, **spec), reqs)
                if got != want:
                    raise AssertionError(
                        f"spec parity {case}: streams differ from plain "
                        f"decode on the card: {got} vs {want}")
                # Prompt lookup rarely finds a draft for every grammar
                # row at once (their random-weight tokens seldom repeat);
                # the self-drafter always drafts.
                if stats["spec_verify_bursts_total"] <= 0 and not (
                        name == "structured" and label == "ngram"):
                    raise AssertionError(f"spec parity {case}: no verify "
                                         f"burst")
                report[case] = {
                    k: stats[k] for k in ("spec_verify_bursts_total",
                                          "spec_proposed_tokens_total",
                                          "spec_accepted_tokens_total",
                                          "num_preempted_total",
                                          "structured_violations_total")}
                if name == "structured":
                    report[case]["streams_equal_plain"] = True
                if name == "structured" and label == "self-drafter" and (
                        stats["spec_accepted_tokens_total"]
                        != stats["spec_proposed_tokens_total"]):
                    # Greedy drafts under the target's own weights and
                    # grammar: a constrained draft step that hid keys
                    # from its live token on the card shows up here.
                    raise AssertionError(
                        f"spec parity {case}: the drafter's "
                        f"{stats['spec_accepted_tokens_total']} of "
                        f"{stats['spec_proposed_tokens_total']} drafts "
                        f"accepted under a grammar")
                if name == "greedy" and label == "self-drafter" and (
                        stats["spec_accepted_tokens_total"]
                        < 0.9 * stats["spec_proposed_tokens_total"]):
                    # The same weights draft: a drafter whose catch-up or
                    # scan reads wrong keys on the card shows up here.
                    raise AssertionError(
                        f"spec parity {case}: the drafter's "
                        f"{stats['spec_accepted_tokens_total']} of "
                        f"{stats['spec_proposed_tokens_total']} drafts "
                        f"accepted")
    print(json.dumps({"spec_parity": report}), flush=True)


KV_BLOCKS = 96  # a small pool: 2,048-token prompts evict each other
KV_BS = 64  # the serving runs' block size
KV_PROMPT = 2048  # tokens: 32 full blocks (31 can be a hit)
KV_MAX_TOKENS = 16
# The kv phases' depth: Llama-3-8B's widths at 8 of its 32 layers (cut to
# pay for the fused and asr phases; a block's movement is the same code
# at any depth, its bytes scale with the layers).
KV_LAYERS = 8


class _BlockStore:
    """A minimal L3 cache server: the JAX cache server's block API
    (``PUT/GET/HEAD /v1/blocks/{hash}``) over a dict, on a thread."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        import threading

        blocks = self.blocks = {}

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _key(self):
                return self.path.rsplit("/", 1)[-1]

            def do_PUT(self):  # noqa: N802 - http.server API
                n = int(self.headers.get("Content-Length") or 0)
                blocks[self._key()] = self.rfile.read(n)
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_GET(self):  # noqa: N802
                data = blocks.get(self._key())
                self.send_response(200 if data is not None else 404)
                self.send_header("Content-Length", str(len(data or b"")))
                self.end_headers()
                if data is not None and self.command == "GET":
                    self.wfile.write(data)

            do_HEAD = do_GET

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)


def _kv_ids(seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [int(t) for t in rng.integers(1, 32000, size=KV_PROMPT)]


def _kv_serve(label, extra, here):
    """One port server on a thread with the KV phase's pool, at
    ``KV_LAYERS`` of Llama-3-8B's layers."""
    import threading

    from production_stack_tpu_torch.engine.server import build_server

    httpd, core = build_server([llama_8b_dir(here, KV_LAYERS)]
                               + SERVE_ARGS[1:] + list(extra) + [
        "--num-blocks", str(KV_BLOCKS), "--block-size", str(KV_BS)])
    threading.Thread(target=httpd.serve_forever, daemon=True,
                     name=f"kv-{label}").start()
    return httpd, core, Client(httpd.server_address[1])


def _kv_stop(*servers):
    for httpd, core, _ in servers:
        httpd.shutdown()
        httpd.server_close()
        core.stop()


def _greedy(client, ids, max_tokens=KV_MAX_TOKENS):
    out = client.post("/v1/completions", {
        "prompt": ids, "max_tokens": max_tokens, "temperature": 0,
        "ignore_eos": True, "stream": True}, stream=True)
    _finish("kv greedy", out)
    return out


def _pull(client, source, ids, kv_path):
    out = client.post("/kv/pull", {"source_url": source.base,
                                   "request": {"prompt": ids},
                                   "kv_path": kv_path})
    return out


def _same(name, got, want):
    if got["text"] != want["text"]:
        raise AssertionError(f"kv {name}: stream {got['text'][:60]!r} is not "
                             f"the prefix-hit stream {want['text'][:60]!r}")


def _move_timings(core, n_blocks: int) -> dict:
    """Spill and restore of ``n_blocks`` pool blocks through the engine's
    own helpers, timed on the host clock with the card synchronised: the
    gather and the pinned copy (enqueue alone, then landed; with fresh
    pinned buffers, then with the allocator's cached ones), and the
    restore from pinned and from pageable host tensors (the same bytes
    written back into the same blocks). Plus the card-to-card move of the
    local-device rung (gather and scatter, CUDA events)."""
    import torch

    bids = list(range(n_blocks))
    nbytes = n_blocks * core._kv_bytes_per_block()
    out = {"blocks": n_blocks, "bytes": nbytes}
    with core._step_lock:
        # The first spill allocates its pinned buffers; the second reuses
        # them from the pinned allocator's cache (a drain after the store
        # has let older buffers go).
        for key in ("spill_first", "spill"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            k, v, ready = core._pages_to_host(bids)
            t1 = time.perf_counter()
            ready()
            t2 = time.perf_counter()
            out[f"{key}_enqueue_ms"] = (t1 - t0) * 1e3
            out[f"{key}_ms"] = (t2 - t0) * 1e3
            if key == "spill_first":
                del k, v, ready
        from production_stack_tpu_torch.engine.core import _leaf_map

        for mode, hashes in (("pinned", range(-1, -n_blocks - 1, -1)),
                             ("pageable", range(-10 ** 6, -10 ** 6 - n_blocks,
                                                -1))):
            for n, h in enumerate(hashes):
                pick = (lambda t, n=n: t[n]) if mode == "pinned" else (
                    lambda t, n=n: t[n].clone())
                core.offload.put(h, _leaf_map(pick, k), _leaf_map(pick, v))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if not core._restore_blocks(list(zip(bids, hashes))):
                raise AssertionError("kv timing: a restore missed")
            torch.cuda.synchronize()
            out[f"restore_{mode}_ms"] = (time.perf_counter() - t0) * 1e3
        sel = torch.tensor(bids, device=core.device)
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        for _ in range(10):
            core._write_pages(bids, *(
                _leaf_map(lambda t: t.index_select(1, sel).transpose(0, 1),
                          pages) for pages in core.kv))
        end.record()
        end.synchronize()
        out["card_to_card_device_ms"] = start.elapsed_time(end) / 10
    for key in ("spill_first", "spill", "restore_pinned",
                "restore_pageable"):
        out[f"{key}_gbps"] = nbytes / (out[f"{key}_ms"] / 1e3) / 1e9
    out["card_to_card_bound_ms"] = 2 * nbytes / 3.35e12 * 1e3
    return out


def _hash_cost() -> dict:
    """Host time of the chain hashes of one 2,048-token prompt (32
    blocks), and of the XXH64 digests alone (their 276-byte inputs: the
    root's text and 64 tokens of 4 bytes)."""
    from production_stack_tpu_torch.engine.kvcache import BlockAllocator
    from production_stack_tpu_torch.utils.xxh64 import xxh64_intdigest

    ids = _kv_ids(99)
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        parent = "meta-llama/Llama-3-8B|"
        for i in range(0, KV_PROMPT, KV_BS):
            parent = BlockAllocator.chain_hash(parent,
                                               tuple(ids[i:i + KV_BS]))
    chain_ms = (time.perf_counter() - t0) / reps * 1e3
    data = bytes(276)
    t0 = time.perf_counter()
    for _ in range(reps * (KV_PROMPT // KV_BS)):
        xxh64_intdigest(data)
    return {"chain_hash_ms_per_2048_tokens": chain_ms,
            "xxh64_ms_per_2048_tokens":
                (time.perf_counter() - t0) / reps * 1e3}


def kv_phase(label: str, extra_args, entries, smi, here):
    """KV movement at Llama-3-8B full width and ``KV_LAYERS`` layers
    (``SERVE_ARGS`` plus ``extra_args``, ``KV_BLOCKS``-block pools),
    driven over HTTP:

    1. one engine with ``--kv-offload-gb 4``: a greedy 2,048-token prompt A
       twice (the second run a prefix hit, ``S_hit``), other 2,048-token
       prompts until every full block of A sits in the host store and
       none in the pool, then A again: it restores at least 31 blocks,
       runs the cached-prefill kernel and gives ``S_hit``;
    2. engines P and D (both over a stdlib L3 block store, remote-only
       tiers): P serves R with ``max_tokens: 1``; D pulls it with
       ``kv_path: "host"`` (32 blocks over TKV2) and serves R with P's
       prefix-hit stream;
    3. the same for R2 with ``kv_path: "auto"``: the local-device rung;
    4. P serves R3 (then its prefix hit) and other prompts until R3's
       blocks have spilled to the L3, flushes; D pulls R3 (P misses:
       ``status: "l3"``) and serves it, restoring through the remote tier,
       with P's prefix-hit stream;
    5. ``/kv/prepare_pull`` on D offers R3's pages through the KV device
       pipe (their handles; released at once).

    Launch counters are set to 0 before the drive and read after it.
    Returns (launch counts by kernel entry, summary)."""

    import torch

    from production_stack_tpu_torch.kv.device_pipe import host_key

    t_phase = time.time()
    summary = {"config": label, "card": smi}
    counters = _counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    prefill_fn, prefill_attr = counters[entries[1]]
    # -- 1. offload and restore ------------------------------------------
    e = _kv_serve("offload", list(extra_args) + ["--kv-offload-gb", "4"],
                  here)
    try:
        _, core, client = e
        a = _kv_ids(1)
        fresh = _greedy(client, a)
        hit = _greedy(client, a)
        a_chain = core.kv_mgr.chain_hashes(a)
        fillers = 0
        while (any(h in core.kv_mgr.allocator.prefix_map for h in a_chain)
               and fillers < 8):
            _greedy(client, _kv_ids(100 + fillers), max_tokens=2)
            fillers += 1
        if not all(core.offload.contains(h) for h in a_chain):
            raise AssertionError(f"kv offload: {fillers} other prompts did "
                                 f"not spill every block of A")
        before = core.stats()["offload"]
        launches0 = getattr(prefill_fn, prefill_attr)
        restored = _greedy(client, a)
        after = core.stats()["offload"]
        restores = after["hits"] - before["hits"]
        if restores < KV_PROMPT // KV_BS - 1:
            raise AssertionError(f"kv offload: {restores} blocks restored")
        if getattr(prefill_fn, prefill_attr) <= launches0:
            raise AssertionError("kv offload: the restored prompt ran no "
                                 "cached-prefill kernel")
        _same("restore", restored, hit)
        summary["offload"] = {
            "fillers": fillers, "restored_blocks": restores,
            "stored": after["stored"], "host_blocks": after["blocks"],
            "host_bytes": after["bytes"],
            "first_token_s": {"fresh": fresh["_first_token_s"],
                              "prefix_hit": hit["_first_token_s"],
                              "restored": restored["_first_token_s"]},
            "fresh_equals_hit": fresh["text"] == hit["text"]}
        summary["moves"] = _move_timings(core, KV_PROMPT // KV_BS)
    finally:
        _kv_stop(e)
    _free_device_memory()
    # -- 2-5. disaggregated prefill, the local-device rung, the L3 -------
    store = _BlockStore()
    remote = ["--kv-remote-url", store.url]
    p = d = None
    try:
        p = _kv_serve("P", list(extra_args) + remote, here)
        d = _kv_serve("D", list(extra_args) + remote, here)
        pc, dc = p[2], d[2]
        for part, seed, kv_path, rung in (("host", 2, "host", "host"),
                                          ("local", 3, "auto",
                                           "local-device")):
            r = _kv_ids(seed)
            _greedy(pc, r, max_tokens=1)  # P prefills, as a prefiller
            out = _pull(dc, pc, r, kv_path)
            if (out.get("status") != "ok" or out["transfer"]["path"] != rung
                    or out["injected_blocks"] != KV_PROMPT // KV_BS):
                raise AssertionError(f"kv {part} pull: {out}")
            got = _greedy(dc, r)
            _same(part, got, _greedy(pc, r))
            summary[part] = dict(out["transfer"],
                                 first_token_s=got["_first_token_s"])
        r3 = _kv_ids(4)
        _greedy(pc, r3)
        s3 = _greedy(pc, r3)  # P's prefix-hit stream
        p_core = p[1]
        r3_chain = p_core.kv_mgr.chain_hashes(r3)
        fillers = 0
        while (any(h in p_core.kv_mgr.allocator.prefix_map for h in r3_chain)
               and fillers < 8):
            _greedy(pc, _kv_ids(200 + fillers), max_tokens=2)
            fillers += 1
        t0 = time.perf_counter()
        if not p_core.offload.flush_remote(timeout=120):
            raise AssertionError("kv l3: P's uploads did not land")
        flush_s = time.perf_counter() - t0
        missing = [h for h in r3_chain if str(h) not in store.blocks]
        if missing:
            raise AssertionError(f"kv l3: {len(missing)} blocks of R3 are "
                                 f"not in the L3")
        out = _pull(dc, pc, r3, "host")
        if out.get("status") != "l3" or out["l3_blocks"] < len(r3_chain):
            raise AssertionError(f"kv l3 pull: {out}")
        d_core = d[1]
        before = d_core.stats()["offload"]
        got = _greedy(dc, r3)
        after = d_core.stats()["offload"]
        fetched = after["remote_get_blocks"] - before["remote_get_blocks"]
        if fetched < len(r3_chain) - 1:
            raise AssertionError(f"kv l3: D fetched {fetched} blocks")
        _same("l3", got, s3)
        summary["l3"] = {
            "fillers": fillers, "flush_s": flush_s,
            "store_blocks": len(store.blocks),
            "p_spill_blocks": p_core.stats()["offload"]["remote_put_blocks"],
            "d_fetched_blocks": fetched,
            "d_fetched_bytes": (after["remote_get_bytes"]
                                - before["remote_get_bytes"]),
            "first_token_s": got["_first_token_s"], "pull": out}
        pipe_probe()  # waits for the availability probe main started
        status, offer = _status(dc, "/kv/prepare_pull",
                                {"prompt": r3, "host_key": host_key()})
        if status != 200 or len(offer["hashes"]) < len(r3_chain) - 1:
            raise AssertionError(f"kv: /kv/prepare_pull answered {status}")
        if _status(dc, "/kv/release", {"uuid": offer["uuid"]})[0] != 200:
            raise AssertionError("kv: /kv/release failed")
        summary["prepare_pull"] = {"status": status,
                                   "blocks": len(offer["hashes"]),
                                   "bytes": offer["bytes"]}
        metrics = dc.get("/metrics")
        for series in ("tpu:kv_transfer_rx_bytes_total",
                       "tpu:kv_transfer_device_pulls_total",
                       "tpu:l3_hit_blocks_total", "tpu:l3_pull_hits_total",
                       'tpu:kv_page_occupancy{model_name='):
            if series not in metrics:
                raise AssertionError(f"kv: /metrics lacks {series}")
    finally:
        _kv_stop(*[s for s in (p, d) if s is not None])
        store.stop()
    launches = {name: getattr(fn, attr)
                for name, (fn, attr) in counters.items()}
    for name, n in launches.items():
        if name in entries and n <= 0:
            raise AssertionError(f"{name} never launched in the kv phase")
        if name not in entries and n != 0:
            raise AssertionError(f"{name} launched {n} times in the {label} "
                                 f"kv phase, which does not use it")
    summary["hash_cost"] = _hash_cost()
    summary["launches"] = {name: launches[name] for name in entries}
    summary["phase_s"] = time.time() - t_phase
    torch.cuda.synchronize()
    return {name: launches[name] for name in entries}, summary


# -- other architectures, LoRA, embeddings and the lifecycle -----------------

OPT_ARGS = ["facebook/opt-125m", "--device", "cuda", "--host", "127.0.0.1",
            "--port", "0", "--max-model-len", "2048", "--max-num-seqs", "8",
            "--seed", "0", "--prefill-batch", "4"]
# Mixtral-8x7B's published config.json, cut to 24 of its 32 layers: all 32
# are 92.9 GB of bf16 weights, beyond an 80 GB card; 24 are 70.2 GB.
MIXTRAL_LAYERS = 24
MIXTRAL_CONFIG = {
    "architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
    "hidden_size": 4096, "intermediate_size": 14336,
    "max_position_embeddings": 32768, "num_attention_heads": 32,
    "num_key_value_heads": 8, "num_hidden_layers": MIXTRAL_LAYERS,
    "num_local_experts": 8, "num_experts_per_tok": 2,
    "rms_norm_eps": 1e-05, "rope_theta": 1000000.0,
    "tie_word_embeddings": False, "vocab_size": 32000,
    "torch_dtype": "bfloat16", "hidden_act": "silu"}
# 8 sequences of 4,096 tokens in 64-token pages: 3.2 GB of bf16 pages at
# 24 layers (the pool is fixed, not sized from the memory left over).
MIXTRAL_BLOCKS = 8 * 4096 // 64
ARCH_PARITY_CFG = dict(device="cuda", dtype="float32", max_model_len=256,
                       max_num_seqs=4, block_size=8, num_blocks=48,
                       min_prefill_bucket=16, prefill_chunk_size=32,
                       max_loras=0)


def mixtral_memory_plan(rows: int = 4, chunk: int = 1024) -> dict:
    """Device bytes the Mixtral phase needs, reckoned from
    ``MIXTRAL_CONFIG`` before anything is allocated: the bf16 weights
    (embedding and head, per layer the attention projections, router,
    the experts' three matrices and two norms), the pool of
    ``MIXTRAL_BLOCKS`` 64-token pages, and the dense MoE's transients at
    a ``[rows, chunk]`` batched prefill (gate, up and their product in
    bf16, SiLU's float32 input, the expert outputs in bf16 and float32,
    for every token and expert)."""
    c = MIXTRAL_CONFIG
    Hd, I, E, V = (c["hidden_size"], c["intermediate_size"],
                   c["num_local_experts"], c["vocab_size"])
    H, KVH, L = (c["num_attention_heads"], c["num_key_value_heads"],
                 c["num_hidden_layers"])
    D = Hd // H
    layer = 2 * Hd * H * D + 2 * Hd * KVH * D + Hd * E + 3 * E * Hd * I \
        + 2 * Hd
    weights = 2 * (2 * V * Hd + L * layer + Hd)
    pool = MIXTRAL_BLOCKS * 64 * L * 2 * KVH * D * 2
    tokens = rows * chunk
    moe = tokens * E * (3 * I * 2 + I * 4 + Hd * 2 + Hd * 4)
    return {"weights": weights, "layer": 2 * layer, "pool": pool,
            "moe_transients": moe, "total": weights + pool + moe}


def mixtral_dir(here: str) -> str:
    """A local model directory holding Mixtral-8x7B's config.json at
    ``MIXTRAL_LAYERS`` layers (no weights: the server draws them from its
    seed), under the kernels' git-ignored build directory."""
    path = os.path.join(here, "production_stack_tpu_torch", "_build",
                        "models", f"Mixtral-8x7B-{MIXTRAL_LAYERS}L")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(MIXTRAL_CONFIG, f, indent=1)
    return path


def decode_profile(core, rows: int = 8, ctx_chars: int = 1000) -> dict:
    """A decode step of a stopped engine (its thread ended), driven on this
    thread as :func:`profile_phase` drives it: ``rows`` sequences at
    ~``ctx_chars`` tokens of context, pipelined bursts timed on the host
    clock three times over three bursts (the least is the step), then two
    bursts under torch.profiler for the device's busy time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from production_stack_tpu_torch.engine.sampling import SamplingParams

    for i in range(rows):
        core.add_request(
            f"prof{i}", core.tokenizer.encode(_text(100 + i, ctx_chars)),
            SamplingParams(temperature=0, max_tokens=400, ignore_eos=True),
            lambda t, f: None)
    K = core.config.decode_steps

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    with torch.inference_mode():
        while True:
            action, req = core.scheduler.next_action()
            if action != "prefill":
                break
            core._do_prefill(req)
        core._do_decode()
        core._flush_pending_burst()
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                core._do_decode()
            torch.cuda.synchronize()
            runs.append(1e3 * (time.perf_counter() - t0) / 3 / K)
        core._flush_pending_burst()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                core._do_decode()
            torch.cuda.synchronize()
        core._flush_pending_burst()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in kernels) / 2 / 1e3 / K
    step_ms = min(runs)
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    with core._lock:
        for seq in core.scheduler.running():
            core.scheduler.finish(seq, "abort")
    return {"decode_rows": rows,
            "decode_host_ms_per_step": step_ms,
            "decode_host_ms_per_step_runs": runs,
            "decode_device_busy_ms_per_step": busy_ms,
            "decode_device_idle_share": max(0.0, 1.0 - busy_ms / step_ms),
            "decode_top_device_ops": [
                {"name": e.key[:70], "calls": e.count,
                 "device_ms_per_step": dev_us(e) / 1e3 / K / 2}
                for e in top]}


def opt_phase(label: str, extra_args, smi):
    """facebook/opt-125m at full width and depth (12 layers, hidden 768,
    12 heads of 64, vocab 50,272, 2,048-token contexts) through the
    port's server, in bf16 pages or ``extra_args`` (int8 pages), driven
    as :func:`serve_phase` drives Llama-3-8B: concurrent greedy
    completions, a 1,900-token prompt in 1,024-token chunks, a prefix
    hit, a storm of six ~2,000-token prompts, a seeded sampled pair; then
    the decode step's host and device time. Both kernels must launch in
    the configured page mode (at G = 1, D = 64), and no other entry.
    Returns (launch counts under the ``_opt`` kernel names, summary)."""
    int8 = bool(extra_args)
    entries = (("paged_attention_int8", "cached_prefill_attention_int8")
               if int8 else ("paged_attention", "cached_prefill_attention"))
    counts, summary = serve_phase(
        label, extra_args, entries, base_args=OPT_ARGS, long_chars=1900,
        hit_chars=1500, after=decode_profile)
    suffix = "_int8" if int8 else ""
    summary["card"] = smi
    return ({"paged_attention_opt" + suffix: counts[entries[0]],
             "cached_prefill_attention_opt" + suffix: counts[entries[1]]},
            summary)


def mixtral_phase(here: str, smi):
    """Mixtral-8x7B at full width (hidden 4,096, 32/8 heads of 128, 8
    experts with top 2, intermediate 14,336, vocab 32,000, rope_theta 1e6)
    and ``MIXTRAL_LAYERS`` layers, bf16, named by a local directory with
    its config.json (the way users name a model that has no preset),
    served and driven as :func:`serve_phase` drives Llama-3-8B; then the
    decode step's host and device time, the dense MoE's device time over
    the step's layers (``moe_mlp`` on the step's ``[8, 1, 4096]`` rows
    behind a spin kernel) and its share of the step's busy time, the
    weight bytes and the peak ``memory_allocated``."""
    import torch

    from production_stack_tpu_torch.models.mixtral import moe_mlp
    from production_stack_tpu_torch.probes.timing import cuda_time_ms

    plan = mixtral_memory_plan()
    card = torch.cuda.get_device_properties(0).total_memory
    all_layers = plan["weights"] + (32 - MIXTRAL_LAYERS) * plan["layer"]
    print(f"[memory] Mixtral-8x7B at {MIXTRAL_LAYERS} layers: weights "
          f"{plan['weights'] / 1e9:.2f} GB ({plan['layer'] / 1e9:.3f} GB a "
          f"layer; 32 layers would be {all_layers / 1e9:.1f} GB), pool "
          f"{plan['pool'] / 1e9:.2f} GB, MoE transients at a [4, 1024] "
          f"prefill {plan['moe_transients'] / 1e9:.2f} GB: "
          f"{plan['total'] / 1e9:.2f} GB of the card's {card / 1e9:.2f} GB",
          flush=True)
    if plan["total"] > card:
        raise AssertionError(f"Mixtral at {MIXTRAL_LAYERS} layers needs "
                             f"{plan['total']} bytes, the card has {card}")
    path = mixtral_dir(here)
    args = [path] + OPT_ARGS[1:7] + [
        "--max-model-len", "4096", "--max-num-seqs", "8", "--seed", "0",
        "--prefill-batch", "4", "--num-blocks", str(MIXTRAL_BLOCKS)]
    torch.cuda.reset_peak_memory_stats()

    def after(core):
        out = decode_profile(core)
        cfg, layers = core.model_config, core.params["layers"]
        h = torch.randn((8, 1, cfg.hidden_size), device="cuda",
                        dtype=cfg.torch_dtype)

        def moe_step():
            for layer in range(cfg.num_layers):
                moe_mlp(cfg, {k: v[layer] for k, v in layers.items()}, h)

        with torch.inference_mode():
            moe_ms = cuda_time_ms(moe_step, iters=3)
        out.update(
            moe_device_ms_per_step=moe_ms,
            moe_share_of_busy=moe_ms / out["decode_device_busy_ms_per_step"],
            peak_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
            memory_plan_gb={k: v / 1e9 for k, v in plan.items()},
            layers=cfg.num_layers, kv_pool_gb=(
                core.num_blocks * core._kv_bytes_per_block() / 1e9))
        return out

    counts, summary = serve_phase(
        f"Mixtral-8x7B ({MIXTRAL_LAYERS} layers) bf16", (),
        ("paged_attention", "cached_prefill_attention"), base_args=args,
        after=after)
    if summary["weight_bytes"] != plan["weights"]:
        raise AssertionError(f"Mixtral weights {summary['weight_bytes']} "
                             f"bytes, reckoned {plan['weights']}")
    summary["card"] = smi
    return counts, summary


def _status(client, path, body=None):
    """(HTTP status, JSON body) of a request that may answer an error."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        client.base + path, data=data,
        headers={"Content-Type": "application/json", **client.headers})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "{}")


def lifecycle_phase(smi):
    """Llama-3-8B bf16 behind the port's server, one engine:

    - LoRA: an adapter loaded by name only (``/v1/load_lora_adapter``,
      timed) is the JAX engine's, whose B matrices stay zero, so its
      greedy stream must equal the base model's; an adapter loaded with
      explicit non-zero weights must change it; both are listed by
      ``/v1/lora_adapters`` and ``/v1/models`` and metered by
      ``tpu:lora_requests_total``; after unloading, the base stream
      returns and the adapter's name is a 404;
    - ``/v1/embeddings`` (a unit vector of 4,096, equal for the same text
      twice), ``/v1/score`` (1 within 1e-3 for a text against itself),
      ``/v1/rerank`` (documents in the order of their scores);
    - ``/sleep`` (``memory_allocated`` falls by the weights plus the pool
      at least; generation answers 503), ``/wake_up`` (a sub-page greedy
      prompt's stream equals its stream before; a 1,100-token prompt
      runs a cached chunk and then hits the prefix cache), both timed;
    - ``/drain`` answers ``drained`` and ``/health`` 503.

    The launch counters are set to 0 just before the drive and read
    after it. Returns (launch counts, summary)."""
    import threading

    import torch

    from production_stack_tpu_torch.engine.server import build_server

    httpd, core = build_server(SERVE_ARGS + ["--max-loras", "4"])
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    client = Client(httpd.server_address[1])
    summary = {"card": smi}
    # Shorter than a 64-token page: no prefix hit, so every repeat takes
    # the path of the first run (bf16 near-ties, ROADMAP Queue 3).
    prompt = _text(60, 40)

    def greedy(model=None):
        body = {"prompt": prompt, "max_tokens": 24, "temperature": 0}
        if model:
            body["model"] = model
        status, out = _status(client, "/v1/completions", body)
        if status != 200:
            raise AssertionError(f"lifecycle: completion {status} {out}")
        _finish("lifecycle", out)
        return out["choices"][0]["text"]

    try:
        _finish("warm-up", client.post("/v1/completions", {
            "prompt": _text(99, 1100), "max_tokens": 9, "temperature": 0}))
        counters = _counters()
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        base = greedy()
        t0 = time.perf_counter()
        status, out = _status(client, "/v1/load_lora_adapter",
                              {"lora_name": "smoke-named"})
        summary["lora_load_by_name_s"] = time.perf_counter() - t0
        if status != 200:
            raise AssertionError(f"lifecycle: load by name {status} {out}")
        if greedy("smoke-named") != base:
            raise AssertionError("lifecycle: a name-only adapter (zero B, "
                                 "as in JAX) changed the greedy stream")
        g = torch.Generator(device="cuda").manual_seed(5)
        weights = {k: 0.05 * torch.randn(
            (v.shape[0],) + tuple(v.shape[2:]), generator=g, device="cuda")
            for k, v in core.params["lora"].items() if k != "scaling"}
        t0 = time.perf_counter()
        if not core.load_lora_adapter("smoke-explicit", weights=weights):
            raise AssertionError("lifecycle: explicit adapter not loaded")
        summary["lora_load_explicit_s"] = time.perf_counter() - t0
        adapted = greedy("smoke-explicit")
        if adapted == base:
            raise AssertionError("lifecycle: an adapter with non-zero "
                                 "weights left the greedy stream as is")
        listed = json.loads(client.get("/v1/lora_adapters"))
        models = [m["id"] for m in json.loads(client.get("/v1/models"))
                  ["data"]]
        for name in ("smoke-named", "smoke-explicit"):
            if name not in [a["lora_name"] for a in listed["adapters"]] \
                    or name not in models:
                raise AssertionError(f"lifecycle: {name} not listed")
        if 'adapter="smoke-explicit"} 1' not in client.get("/metrics"):
            raise AssertionError("lifecycle: tpu:lora_requests_total")
        status, _ = _status(client, "/v1/unload_lora_adapter",
                            {"lora_name": "smoke-explicit"})
        if status != 200 or greedy() != base:
            raise AssertionError("lifecycle: unload did not restore the "
                                 "base stream")
        if _status(client, "/v1/completions", {
                "model": "smoke-explicit", "prompt": prompt})[0] != 404:
            raise AssertionError("lifecycle: an unloaded adapter's name "
                                 "is not a 404")

        text, other = _text(61, 300), _text(62, 300)
        emb = client.post("/v1/embeddings", {"input": [text, text]})
        vecs = [torch.tensor(d["embedding"]) for d in emb["data"]]
        norms = [float(v.norm()) for v in vecs]
        if len(vecs[0]) != 4096 or any(abs(n - 1) > 1e-3 for n in norms) \
                or not torch.equal(vecs[0], vecs[1]):
            raise AssertionError(f"lifecycle: embeddings {len(vecs[0])} "
                                 f"dims, norms {norms}")
        sc = client.post("/v1/score", {"text_1": text,
                                       "text_2": [text, other]})
        scores = [d["score"] for d in sc["data"]]
        if abs(scores[0] - 1.0) > 1e-3:
            raise AssertionError(f"lifecycle: self-score {scores[0]}")
        rr = client.post("/v1/rerank", {"query": text,
                                        "documents": [other, text]})
        ranked = [r["index"] for r in rr["results"]]
        rel = [r["relevance_score"] for r in rr["results"]]
        if ranked != [1, 0] or rel != sorted(rel, reverse=True):
            raise AssertionError(f"lifecycle: rerank {rr['results']}")
        summary.update(embedding_dims=len(vecs[0]), embedding_norms=norms,
                       self_score=scores[0], other_score=scores[1],
                       rerank_order=ranked)

        weight_bytes = _weight_bytes(core.params)[0]
        pool_bytes = core.num_blocks * core._kv_bytes_per_block()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        status, out = _status(client, "/sleep?level=1", {})
        sleep_s = time.perf_counter() - t0
        asleep = torch.cuda.memory_allocated()
        if status != 200 or not json.loads(
                client.get("/is_sleeping"))["is_sleeping"]:
            raise AssertionError(f"lifecycle: /sleep {status} {out}")
        if before - asleep < weight_bytes + pool_bytes:
            raise AssertionError(
                f"lifecycle: sleep freed {before - asleep} bytes, under the "
                f"weights {weight_bytes} plus the pool {pool_bytes}")
        if _status(client, "/v1/completions", {"prompt": prompt})[0] != 503:
            raise AssertionError("lifecycle: generation while asleep is "
                                 "not a 503")
        t0 = time.perf_counter()
        status, _ = _status(client, "/wake_up", {})
        wake_s = time.perf_counter() - t0
        if status != 200 or greedy() != base:
            raise AssertionError("lifecycle: the stream after /wake_up "
                                 "differs from the stream before /sleep")
        # The pool is fresh: a 1,100-token prompt runs its second chunk
        # through the cached-prefill kernel, and its repeat hits.
        for _ in range(2):
            _finish("after wake", client.post("/v1/completions", {
                "prompt": _text(99, 1100), "max_tokens": 4,
                "temperature": 0}))
        summary.update(
            weight_bytes=weight_bytes, pool_bytes=pool_bytes,
            memory_allocated_before_gb=before / 1e9,
            memory_allocated_asleep_gb=asleep / 1e9,
            freed_gb=(before - asleep) / 1e9, sleep_s=sleep_s,
            wake_s=wake_s, wake_gb_per_s=weight_bytes / wake_s / 1e9,
            host_copy="pinned")
        launches = {name: getattr(fn, attr)
                    for name, (fn, attr) in counters.items()}
        status, out = _status(client, "/drain?timeout_s=10", {})
        if status != 200 or out.get("status") != "drained":
            raise AssertionError(f"lifecycle: /drain {status} {out}")
        if _status(client, "/health")[0] != 503:
            raise AssertionError("lifecycle: /health is not 503 drained")
        summary["drain"] = out
    finally:
        httpd.shutdown()
        httpd.server_close()
        core.stop()
    for name in ("paged_attention", "cached_prefill_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"lifecycle: {name} never launched")
    summary["launches"] = launches
    return {k: launches[k] for k in ("paged_attention",
                                     "cached_prefill_attention")}, summary


def arch_parity_phase(smi):
    """tiny-opt and tiny-mixtral at float32 on the card (the kernels' f32
    mode), each engine driven twice on the same parameters: on the card
    and on the CPU (the plain versions). Greedy and seeded sampled rows
    arrive together into a 48-block pool of 8-token pages and 32-token
    chunks (so longer prompts run chunk continuations and a tight
    request set preempts), then a prompt over the first's prefix hits
    the cache. Every stream must be equal token for token, and on the
    card both kernels must have launched. Prints an ``{"arch_parity":
    ...}`` line."""
    import queue

    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.core import EngineCore, _tree_map
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    def greedy(n):
        return SamplingParams(max_tokens=n, temperature=0.0,
                              ignore_eos=True)

    def sampled(seed):
        return SamplingParams(max_tokens=40, temperature=0.8, top_p=0.9,
                              seed=seed, ignore_eos=True)

    first = [(list(range(300, 370)), greedy(60)),
             (list(range(20, 61)), sampled(11)),
             (list(range(100, 190)), greedy(80)),
             (list(range(400, 450)), sampled(12))]
    second = [(list(range(300, 340)) + [5, 6, 7], greedy(24))]

    def run(eng, reqs):
        queues = []
        with eng._lock:
            for i, (prompt, sp) in enumerate(reqs):
                q = queue.Queue()
                eng.add_request(f"a{time.time_ns()}-{i}", prompt, sp,
                                lambda t, f, q=q: q.put((t, f)))
                queues.append(q)
        out = []
        for q in queues:
            tokens = []
            while True:
                t, f = q.get(timeout=300)
                if t is not None:
                    tokens.append(t)
                if f is not None:
                    out.append((tokens, f))
                    break
        return out

    counters = _counters()
    report = {"card": smi, "dtype": "float32"}
    for model in ("tiny-opt", "tiny-mixtral"):
        streams, stats = {}, {}
        for device in ("cuda", "cpu"):
            cfg = EngineConfig(model=model, **dict(ARCH_PARITY_CFG,
                                                   device=device))
            params = None
            if device == "cpu":
                params = _tree_map(lambda t: t.cpu(), card_params)
            eng = EngineCore(cfg, params=params)
            if device == "cuda":
                card_params = eng.params
                for fn, attr in counters.values():
                    setattr(fn, attr, 0)
            eng.start()
            try:
                streams[device] = run(eng, first) + run(eng, second)
            finally:
                eng.stop()
            stats[device] = {k: eng.stats()[k] for k in (
                "num_preempted_total", "cached_tokens_total",
                "prefill_chunks_total")}
            if device == "cuda":
                launches = {name: getattr(fn, attr)
                            for name, (fn, attr) in counters.items()}
        if streams["cuda"] != streams["cpu"]:
            raise AssertionError(f"arch parity {model}: card streams differ "
                                 f"from the CPU's: {streams}")
        if stats["cuda"]["num_preempted_total"] <= 0 or \
                stats["cuda"]["cached_tokens_total"] <= 0:
            raise AssertionError(f"arch parity {model}: no preemption or "
                                 f"no prefix hit: {stats}")
        for name in ("paged_attention", "cached_prefill_attention"):
            if launches[name] <= 0:
                raise AssertionError(f"arch parity {model}: {name} never "
                                     f"launched on the card")
        report[model] = dict(stats["cuda"], streams_equal_cpu=True,
                             tokens=sum(len(t) for t, _ in streams["cuda"]),
                             launches={k: launches[k] for k in (
                                 "paged_attention",
                                 "cached_prefill_attention")})
    print(json.dumps({"arch_parity": report}), flush=True)


CKPT_MODEL = "meta-llama/Llama-3-8B"
CKPT_LAYERS = 4  # of Llama-3-8B's 32: 3.85 GB of bf16 on disk
CKPT_OPT = "facebook/opt-125m"
CKPT_DEVICE = "cuda"
CKPT_KEY = "sk-chip-smoke"
CKPT_MAX_TOKENS = 24
# A drafter for the tiny-llama-width target directory: its vocabulary,
# one layer.
CKPT_DRAFT = dict(name="ckpt-draft", hidden_size=64, num_layers=1,
                  num_heads=2, num_kv_heads=1, head_dim=32,
                  intermediate_size=128)


def _flat_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _tree_to(tree: dict, device) -> dict:
    return {k: (_tree_to(v, device) if isinstance(v, dict)
                else v.to(device)) for k, v in tree.items()}


def _same_tree(label: str, got: dict, want: dict) -> dict:
    """Every leaf of ``want`` in ``got`` (LoRA slots aside), equal bit for
    bit: (leaves compared, their bytes, the largest absolute difference,
    which must be 0)."""
    import torch

    got = {k: v for k, v in _flat_leaves(got) if not k.startswith("lora.")}
    want = dict(_flat_leaves(want))
    if sorted(got) != sorted(want):
        raise AssertionError(f"{label}: loaded leaves "
                             f"{sorted(set(got) ^ set(want))} differ")
    def bits(t):
        return t.contiguous().view(-1).view(torch.uint8)

    worst, nbytes = 0.0, 0
    for name, w in want.items():
        g = got[name]
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{label}: {name} is {g.dtype} "
                                 f"{tuple(g.shape)}, not {w.dtype} "
                                 f"{tuple(w.shape)}")
        w = w.to(g.device)
        diff = (g.float() - w.float()).abs().max().item()
        worst = max(worst, diff)
        if not torch.equal(bits(g), bits(w)):
            raise AssertionError(f"{label}: {name} differs from the written "
                                 f"tensor (max abs {diff})")
        nbytes += g.numel() * g.element_size()
    return {"leaves": len(want), "bytes": nbytes, "max_abs_diff": worst}


def _ckpt_ids(seed: int, n: int):
    """A prompt of ``n`` token ids from a seed: the directory's tokenizer
    (bytes, or whatever tokenizer the host's ``transformers`` builds for
    a directory without tokenizer files) then never decides how many
    tokens a prompt has."""
    import numpy as np

    return [int(t) for t in
            np.random.default_rng(seed).integers(1, 32000, size=n)]


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def _checkpoint_serve(label, llama_dir, want, extra, entries, smi):
    """Serve the Llama checkpoint directory behind the deployment key and
    drive it: a bare request gets 401; with the key greedy prompts shorter
    than a page (each alone: their streams are compared with the
    ``params_from_numpy`` engine's), four concurrent completions, a
    2,500-token prompt in chunks and a prefix hit, an ``X-Request-Id``
    echoed, a 1 s ``/debug/profile`` capture beside a request, and
    ``/debug/traces`` listing the served requests with stage times that
    add up. Returns (launches of ``entries``, summary, greedy texts)."""
    import threading

    from production_stack_tpu_torch.engine.server import build_server

    args = [llama_dir, "--device", CKPT_DEVICE, "--host", "127.0.0.1",
            "--port", "0", "--max-model-len", "4096", "--max-num-seqs", "8",
            "--seed", "0", "--prefill-batch", "4", "--api-key", CKPT_KEY,
            *extra]
    t0 = time.time()
    httpd, core = build_server(args)
    summary = {"config": label, "engine_init_s": time.time() - t0,
               "engine_load_s": core.checkpoint_load_s,
               "tokenizer": type(core.tokenizer).__name__}
    summary["weights"] = _same_tree(label, core.params, want)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_address[1]
    client = Client(port, {"Authorization": f"Bearer {CKPT_KEY}"})
    try:
        status, body = _status(Client(port), "/v1/completions", {
            "prompt": "no key", "max_tokens": 2})
        if status != 401 or body["error"]["type"] != "AuthenticationError":
            raise AssertionError(f"{label}: a request without the key got "
                                 f"{status} {body}")
        _finish("warm-up", client.post("/v1/completions", {
            "prompt": _ckpt_ids(99, 1100), "max_tokens": 9,
            "temperature": 0}))
        counters = _counters()
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        greedy = []
        for i in range(3):  # shorter than a page: never a prefix hit
            out = client.post("/v1/completions", {
                "prompt": _ckpt_ids(60 + i, 40),
                "max_tokens": CKPT_MAX_TOKENS, "temperature": 0})
            _finish(f"greedy {i}", out)
            greedy.append(out["choices"][0]["text"])
        results = [None] * 4

        def run(i):
            results[i] = client.post("/v1/completions", {
                "prompt": _ckpt_ids(70 + i, 300), "max_tokens": 16,
                "temperature": 0})

        threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        # A 1 s profile capture while the four decode.
        prof = client.post("/debug/profile", {"duration_s": 1.0})
        for th in threads:
            th.join(timeout=600)
        for i, out in enumerate(results):
            if out is None:
                raise AssertionError(f"{label}: concurrent {i} got no reply")
            _finish(f"concurrent {i}", out)
        if not prof.get("ok") or not prof.get("files"):
            raise AssertionError(f"{label}: /debug/profile left no "
                                 f"artifact: {prof}")
        listing = json.loads(client.get("/debug/profile/artifacts"))
        if not set(prof["files"]) <= set(listing["files"]):
            raise AssertionError(f"{label}: artifacts not listed")
        long_prompt = _ckpt_ids(80, 2500)  # chunks of 1,024, 1,024, 452
        long_out = client.post("/v1/completions", {
            "prompt": long_prompt, "max_tokens": 16, "temperature": 0})
        _finish("long prompt", long_out)
        hit_out = client.post("/v1/completions", {
            "prompt": long_prompt[:2000] + _ckpt_ids(81, 300),
            "max_tokens": 16, "temperature": 0})
        _finish("prefix hit", hit_out)
        import urllib.request

        rid = f"ckpt-router-rid-{len(extra)}"
        req = urllib.request.Request(
            client.base + "/v1/completions", data=json.dumps({
                "prompt": _ckpt_ids(82, 40), "max_tokens": 4}).encode(),
            headers={"Content-Type": "application/json", "X-Request-Id": rid,
                     **client.headers})
        with urllib.request.urlopen(req, timeout=600) as resp:
            echoed = resp.headers.get("X-Request-Id")
            body = json.loads(resp.read().decode())
        if echoed != rid or body["id"] != rid:
            raise AssertionError(f"{label}: X-Request-Id {rid!r} came back "
                                 f"as {echoed!r} / {body['id']!r}")
        launches = {name: getattr(fn, attr)
                    for name, (fn, attr) in counters.items()}
        traces = json.loads(client.get("/debug/traces?limit=500"))["traces"]
        if rid not in {t["request_id"] for t in traces} or len(traces) < 11:
            raise AssertionError(f"{label}: /debug/traces lists "
                                 f"{len(traces)} requests, not the served")
        doc = json.loads(client.get(f"/debug/traces/{rid}"))
        spans = {s["name"]: s["duration_s"] for s in doc["spans"]}
        stages = sum(spans.get(n, 0.0) for n in (
            "engine.queue", "engine.prefill", "engine.decode"))
        if not 0 < stages <= spans["engine.request"] + 1e-5:
            raise AssertionError(f"{label}: stage times {spans} do not add "
                                 f"up")
        hits = core.stats()["prefix_cache_hits"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        core.stop()
    for name, n in launches.items():
        if name in entries and n <= 0:
            raise AssertionError(f"{name} never launched on the {label} "
                                 f"checkpoint path")
        if name not in entries and n != 0:
            raise AssertionError(f"{name} launched {n} times on the {label} "
                                 f"checkpoint path, which does not use it")
    if hits <= 0:
        raise AssertionError(f"{label}: no prefix-cache hit was served")
    summary.update(launches={n: launches[n] for n in entries},
                   traces_listed=len(traces), stage_spans_s=spans,
                   profile_files=prof["files"],
                   long_latency_s=long_out["_latency_s"],
                   hit_latency_s=hit_out["_latency_s"], card=smi)
    return {n: launches[n] for n in entries}, summary, greedy


def _reference_greedy(llama_dir, want, extra) -> list:
    """The greedy texts of :func:`_checkpoint_serve`'s short prompts from
    an engine on the same configuration whose weights are the written
    tensors, carried across by ``params_from_numpy``, not read from the
    directory."""
    import threading

    from production_stack_tpu_torch.engine.core import EngineCore
    from production_stack_tpu_torch.engine.server import (
        build_arg_parser,
        build_server,
        config_from_args,
    )
    from production_stack_tpu_torch.models import get_model_config
    from production_stack_tpu_torch.models.convert import params_from_numpy

    args = [llama_dir, "--device", CKPT_DEVICE, "--host", "127.0.0.1",
            "--port", "0", "--max-model-len", "4096", "--max-num-seqs", "8",
            "--seed", "0", "--prefill-batch", "4", *extra]
    config = config_from_args(build_arg_parser().parse_args(args))
    core = EngineCore(config, params=params_from_numpy(
        want, get_model_config(llama_dir), CKPT_DEVICE))
    if core.checkpoint_load_s is not None:
        raise AssertionError("the reference engine read the directory")
    httpd, core = build_server(args, core=core)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    client = Client(httpd.server_address[1])
    try:
        _finish("warm-up", client.post("/v1/completions", {
            "prompt": _ckpt_ids(99, 1100), "max_tokens": 9,
            "temperature": 0}))
        texts = []
        for i in range(3):
            out = client.post("/v1/completions", {
                "prompt": _ckpt_ids(60 + i, 40),
                "max_tokens": CKPT_MAX_TOKENS, "temperature": 0})
            texts.append(out["choices"][0]["text"])
    finally:
        httpd.shutdown()
        httpd.server_close()
        core.stop()
    return texts


def _engine_streams(core, prompts, max_tokens):
    """Greedy token streams of ``prompts``, queued at once under the
    engine's lock."""
    import queue

    from production_stack_tpu_torch.engine.sampling import SamplingParams

    core.start()
    queues = []
    try:
        with core._lock:
            for i, prompt in enumerate(prompts):
                q = queue.Queue()
                core.add_request(f"c{i}", list(prompt), SamplingParams(
                    max_tokens=max_tokens, temperature=0.0,
                    ignore_eos=True), lambda t, f, q=q: q.put((t, f)))
                queues.append(q)
        out = []
        for q in queues:
            tokens = []
            while True:
                t, f = q.get(timeout=300)
                if t is not None:
                    tokens.append(t)
                if f is not None:
                    out.append((tokens, f))
                    break
    finally:
        core.stop()
    return out


def checkpoint_phase(here: str, smi):
    """Local checkpoints on the card. Writes, into a temporary directory
    under ``production_stack_tpu_torch/_build/`` that it deletes
    afterwards, with the port's standard-library safetensors writer
    (HF tensor names and a config.json; no ``safetensors`` or
    ``transformers`` needed):

    - Llama-3-8B at full width cut to ``CKPT_LAYERS`` of its 32 layers,
      bf16 weights drawn from a seed on the card, in two shards;
    - facebook/opt-125m at full size as one ``pytorch_model.bin``;
    - a tiny-llama-width target and a one-layer drafter of its
      vocabulary, float32.

    The Llama directory is read back (host rate), then served twice
    behind the deployment key (:func:`_checkpoint_serve`): bf16, and
    ``--kv-cache-dtype int8 --quantization int8``, where the loaded
    tree must equal ``quantize_loaded`` of the written one. Every leaf
    must land bit for bit, both kernels must launch, and the greedy texts
    must equal those of an engine whose weights are the written tensors
    (:func:`_reference_greedy`). OPT must load bit for bit from the
    ``.bin`` and serve; the drafter directory must load bit for bit and
    its speculative streams equal plain decode's. Returns (launches of
    the served runs, summary)."""
    import shutil
    import tempfile

    import torch

    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.core import EngineCore
    from production_stack_tpu_torch.models import build_model
    from production_stack_tpu_torch.models import get_model_config
    from production_stack_tpu_torch.models.quantize import quantize_loaded
    from production_stack_tpu_torch.models.weights import (
        load_checkpoint,
        save_checkpoint,
    )

    def drawn(cfg, seed, device=CKPT_DEVICE):
        init, _ = build_model(cfg)
        with torch.no_grad():
            return init(cfg, torch.Generator(device=device).manual_seed(seed),
                        device)

    build = os.path.join(here, "production_stack_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ckpt-", dir=build)
    launches = {}
    try:
        cfg = get_model_config(CKPT_MODEL).replace(num_layers=CKPT_LAYERS)
        llama_dir = os.path.join(tmp, "llama-3-8b-8l")
        tree = drawn(cfg, 11)
        t0 = time.time()
        tensor_bytes = save_checkpoint(tree, cfg, llama_dir, shards=2)
        write_s = time.time() - t0
        disk = _dir_bytes(llama_dir)
        log(f"[checkpoint] wrote {disk / 1e9:.2f} GB in {write_s:.1f} s")
        t0 = time.time()
        host = load_checkpoint(cfg, llama_dir)
        read_s = time.time() - t0
        host_check = _same_tree("host read", host, tree)
        del host
        summary = {"model": CKPT_MODEL, "layers": CKPT_LAYERS,
                   "of_layers": get_model_config(CKPT_MODEL).num_layers, "dtype": "bfloat16", "shards": 2,
                   "file_bytes": disk, "tensor_bytes": tensor_bytes,
                   "write_s": write_s, "host_read_s": read_s,
                   "host_read_gb_per_s": disk / read_s / 1e9,
                   "host_read_leaves": host_check["leaves"], "card": smi,
                   "runs": []}
        for label, extra, entries in (
                ("bf16", (), ("paged_attention", "cached_prefill_attention")),
                ("int8 KV + int8 weights", INT8_ARGS,
                 ("paged_attention_int8", "cached_prefill_attention_int8"))):
            _free_device_memory()
            # The engine quantizes on the host; so does the check (on the
            # card a float32 quotient by a scalar is a product by its
            # reciprocal, which can land one ulp away).
            want = tree if not extra else quantize_loaded(
                _tree_to(tree, "cpu"), "llama")
            counts, run, greedy = _checkpoint_serve(
                label, llama_dir, want, extra, entries, smi)
            for name, n in counts.items():
                launches[name] = launches.get(name, 0) + n
            _free_device_memory()
            reference = _reference_greedy(llama_dir, want, extra)
            if greedy != reference:
                raise AssertionError(
                    f"checkpoint {label}: greedy texts {greedy} differ from "
                    f"the params_from_numpy engine's {reference}")
            run["greedy_equal_to_params_from_numpy"] = len(greedy)
            run["load_gb_per_s"] = disk / run["engine_load_s"] / 1e9
            run["device_weight_bytes"] = run["weights"]["bytes"]
            summary["runs"].append(run)
            del want
            log(f"[checkpoint] {json.dumps(run)}")
        del tree
        _free_device_memory()
        # OPT-125m at full size from a pytorch_model.bin.
        opt_cfg = get_model_config(CKPT_OPT)
        opt_dir = os.path.join(tmp, "opt-125m")
        opt_tree = drawn(opt_cfg, 12)
        save_checkpoint(opt_tree, opt_cfg, opt_dir, torch_bin=True)
        core = EngineCore(EngineConfig(
            model=opt_dir, device=CKPT_DEVICE, max_model_len=2048,
            max_num_seqs=4, num_blocks=256))
        summary["opt_bin"] = dict(_same_tree("opt-125m", core.params,
                                             opt_tree),
                                  load_s=core.checkpoint_load_s)
        (tokens, finish), = _engine_streams(core, [list(range(1, 1500))], 8)
        if finish != "length" or len(tokens) != 8:
            raise AssertionError(f"opt-125m checkpoint: {finish} {tokens}")
        del core, opt_tree
        _free_device_memory()
        # A draft directory for --speculative-draft-model.
        t_cfg = get_model_config("tiny-llama").replace(dtype="float32")
        d_cfg = t_cfg.replace(**CKPT_DRAFT)
        target_dir = os.path.join(tmp, "tiny-target")
        draft_dir = os.path.join(tmp, "tiny-draft")
        save_checkpoint(drawn(t_cfg, 13), t_cfg, target_dir)
        d_tree = drawn(d_cfg, 14)
        save_checkpoint(d_tree, d_cfg, draft_dir)
        plain_cfg = dict(SPEC_PARITY_CFG, model=target_dir,
                         device=CKPT_DEVICE)
        prompts = [[5, 6, 7, 8] * 6, [31, 7, 2, 19, 44, 3, 28, 11]]
        want = _engine_streams(EngineCore(EngineConfig(**plain_cfg)),
                               prompts, 24)
        spec = EngineCore(EngineConfig(
            **plain_cfg, speculative_num_tokens=4,
            speculative_draft_model=draft_dir))
        draft_check = _same_tree("draft", spec._draft.params, d_tree)
        got = _engine_streams(spec, prompts, 24)
        stats = spec.stats()
        if got != want:
            raise AssertionError(f"draft checkpoint: speculative streams "
                                 f"{got} differ from plain {want}")
        if stats["spec_verify_bursts_total"] <= 0:
            raise AssertionError("draft checkpoint: no verify burst ran")
        summary["draft"] = dict(
            draft_check, streams_equal=len(got),
            proposed=stats["spec_proposed_by_source"]["draft_model"],
            accepted=stats["spec_accepted_by_source"]["draft_model"])
        del spec
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        _free_device_memory()
    return launches, summary


def _free_device_memory() -> None:
    """Drop what a finished engine left (its server's handler class holds
    it in a reference cycle) and return the cached blocks to the card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def profile_phase(extra_args=()) -> dict:
    """Where a decode step's time goes: Llama-3-8B (``SERVE_ARGS`` plus
    ``extra_args``) with 8 sequences decoding at ~1k context, the engine's
    steps driven on this thread (the engine thread is not started). Two
    ways to run the bursts: "serial" reads each burst back before
    launching the next (the engine's order before pipelining),
    "pipelined" launches burst N+1 before reading burst N back (the
    engine's step). Each is timed five times, alternating, over three
    bursts after a warm-up burst (host clock, to the card's completion),
    before any profiling (the profiler slows later launches): the least
    of the five is the step (a stall of the shared host only adds time),
    and the engine's readback wait (``flush_time_total``) is what the
    pipelining can hide. Then each is profiled over two bursts under
    torch.profiler for the device's busy time. Idle share = 1 - busy /
    the least unprofiled step. The pipelined op table goes to standard
    error."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from production_stack_tpu_torch.engine.core import EngineCore
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.engine.server import (
        build_arg_parser,
        config_from_args,
    )

    core = EngineCore(config_from_args(build_arg_parser().parse_args(
        SERVE_ARGS + list(extra_args))))
    for i in range(core.config.max_num_seqs):
        core.add_request(
            f"p{i}", core.tokenizer.encode(_text(100 + i, 1000)),
            SamplingParams(temperature=0, max_tokens=800, ignore_eos=True),
            lambda t, f: None)
    K = core.config.decode_steps

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    def burst(mode):
        core._do_decode()
        if mode == "serial":
            core._flush_pending_burst()

    times = {"serial": [], "pipelined": []}
    waits = {"serial": [], "pipelined": []}
    modes = {}
    with torch.inference_mode():
        while True:
            action, req = core.scheduler.next_action()
            if action != "prefill":
                break
            core._do_prefill(req)
        core._do_decode()  # warm-up burst (lands the first tokens)
        core._flush_pending_burst()
        for _ in range(5):
            for mode in times:
                burst(mode)
                torch.cuda.synchronize()
                w0 = core.flush_time_total
                t0 = time.perf_counter()
                for _ in range(3):
                    burst(mode)
                torch.cuda.synchronize()
                times[mode].append(1e3 * (time.perf_counter() - t0) / 3 / K)
                waits[mode].append(1e3 * (core.flush_time_total - w0) / 3 / K)
                core._flush_pending_burst()
        for mode in times:
            burst(mode)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(2):
                    burst(mode)
                torch.cuda.synchronize()
                prof_wall_s = (time.perf_counter() - t0) / 2
            core._flush_pending_burst()
            # Device-side rows only (kernels, copies, memsets): the CPU op
            # rows carry their kernels' time as well.
            kernels = [e for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA]
            busy_ms = sum(dev_us(e) for e in kernels) / 2 / 1e3 / K
            step_ms = min(times[mode])
            top = sorted(kernels, key=dev_us, reverse=True)[:12]
            modes[mode] = {
                "ms_per_step": step_ms, "ms_per_step_runs": times[mode],
                "readback_wait_ms_per_step": sum(waits[mode]) / 5,
                "profiled_ms_per_step": 1e3 * prof_wall_s / K,
                "device_busy_ms_per_step": busy_ms,
                "device_idle_share": max(0.0, 1.0 - busy_ms / step_ms),
                "top_device_ops": [
                    {"name": e.key[:70], "calls": e.count,
                     "device_ms_per_step": dev_us(e) / 1e3 / K / 2}
                    for e in top]}
            if mode == "pipelined":
                log(prof.key_averages().table(row_limit=40))
    core.stop()
    return {
        "config": " ".join(extra_args) or "bf16",
        "rows": core.config.max_num_seqs, "steps_per_burst": K,
        "context_tokens": [len(s.req.all_token_ids)
                           for s in core.scheduler.running()],
        "serial": modes["serial"], "pipelined": modes["pipelined"],
    }


def profile_structured_phase() -> dict:
    """The mask term in served decode bursts: Llama-3-8B bf16 with 8
    sequences at ~1k context, each under a grammar that never closes
    (``[a-z ]*``; EOS ignored), driven on this thread as in
    :func:`profile_phase`. A structured row takes one token a burst and
    reads each burst back before the next (the collapsed pipeline). The
    step is timed five times over three bursts, then two bursts are
    profiled with the mask term's two calls (``fsm_allowed`` once a
    burst, ``mask_disallowed`` each step) under named ranges: the device
    time of the kernels and copies each launches, a call and a step (a
    range's own device span would count the card's waits between its
    launches too), the device's busy time and idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    import production_stack_tpu_torch.engine.core as core_mod
    from production_stack_tpu_torch.engine.core import EngineCore
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.engine.server import (
        build_arg_parser,
        config_from_args,
    )
    from production_stack_tpu_torch.structured.api import parse_structured

    core = EngineCore(config_from_args(build_arg_parser().parse_args(
        SERVE_ARGS)))
    spec = parse_structured({"guided_regex": "[a-z ]*"})
    for i in range(core.config.max_num_seqs):
        core.add_request(
            f"s{i}", core.tokenizer.encode(_text(100 + i, 1000)),
            SamplingParams(temperature=0, max_tokens=800, ignore_eos=True,
                           structured=spec),
            lambda t, f: None)
    K = core.config.decode_steps
    names = ("fsm_allowed", "mask_disallowed")
    originals = {n: getattr(core_mod, n) for n in names}

    def named(n):
        def call(*a, **k):
            with record_function(n):
                return originals[n](*a, **k)
        return call

    def self_dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    runs = []
    with torch.inference_mode():
        while True:
            action, req = core.scheduler.next_action()
            if action != "prefill":
                break
            core._do_prefill(req)
        core._do_decode()
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                core._do_decode()
            core._flush_pending_burst()
            torch.cuda.synchronize()
            runs.append(1e3 * (time.perf_counter() - t0) / 3 / K)
        for n in names:
            setattr(core_mod, n, named(n))
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(2):
                    core._do_decode()
                core._flush_pending_burst()
                torch.cuda.synchronize()
        finally:
            for n in names:
                setattr(core_mod, n, originals[n])
    stats = core.stats()
    core.stop()
    # The device work under each range, by kernel (or copy) name.
    breakdown = {n: {} for n in names}

    calls = {n: 0 for n in names}

    def collect(ev, into):
        for k in getattr(ev, "kernels", []):
            into[k.name[:100]] = into.get(k.name[:100], 0.0) + k.duration
        for child in ev.cpu_children:
            collect(child, into)

    for ev in prof.events():
        # The host-side range (the trace also holds its device-side span).
        if ev.name in names and ev.device_type == DeviceType.CPU:
            calls[ev.name] += 1
            collect(ev, breakdown[ev.name])
    events = prof.key_averages()
    log(events.table(sort_by="self_cuda_time_total", row_limit=30))
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(self_dev_us(e) for e in kernels) / 2 / 1e3 / K
    if not all(calls.values()) or not all(breakdown.values()):
        raise AssertionError(f"profile: the mask term's ranges {calls} "
                             f"launched {breakdown}")
    mask = {n: {"calls": calls[n],
                "device_us_per_call": sum(breakdown[n].values()) / calls[n],
                "device_ms_per_step": sum(breakdown[n].values()) / 1e3
                / K / 2,
                "kernels_us_per_call": {k: us / calls[n]
                                        for k, us in breakdown[n].items()}}
            for n in names}
    return {
        "config": "bf16, 8 structured rows ([a-z ]*)",
        "rows": core.config.max_num_seqs, "steps_per_burst": K,
        "ms_per_step": min(runs), "ms_per_step_runs": runs,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / min(runs)),
        "mask_term": mask,
        "mask_term_device_ms_per_step": sum(
            m["device_ms_per_step"] for m in mask.values()),
        "structured_violations_total": stats["structured_violations_total"],
        "structured_mask_states_total": stats["structured_mask_states_total"]}


# -- tensor parallelism -------------------------------------------------------

# A tensor-parallel rank's heads (the kernels see only these): Llama-3-8B
# (32/8 heads of 128) at tp 2, 4 and 8, OPT-125m (12 heads of 64, G 1) at
# tp 2 and 4. name suffix -> (model, H, KVH, D).
TP_SHAPES = {"tp2": ("llama", 16, 4, 128), "tp4": ("llama", 8, 2, 128),
             "tp8": ("llama", 4, 1, 128), "opt_tp2": ("opt", 6, 6, 64),
             "opt_tp4": ("opt", 3, 3, 64)}
for _suffix in TP_SHAPES:
    KERNELS["paged_attention_" + _suffix] = (run_decode, plain_decode)
    KERNELS["cached_prefill_attention_" + _suffix] = (run_prefill,
                                                      plain_prefill)


def tp_shape_key(H: int, KVH: int, D: int) -> str:
    """The wrappers' ``launches_by_shape`` key of a bf16 launch."""
    from production_stack_tpu_torch.ops.paged_attention import launch_shape

    import torch

    return launch_shape(H, KVH, D, torch.bfloat16, False)


def tp_kernel_phase() -> dict:
    """Both kernels at every per-rank shape of ``TP_SHAPES`` in bf16:
    decode 8 x 2,048 and ragged, cached prefill 1,024 over 1,024 and the
    ragged third chunk of a 2,500-token prompt (OPT: the second chunk of a
    1,901-token one); each held to its plain version at the row bar, the
    8 x 2,048 decode and the 1,024/1,024 prefill also at 2e-3 absolute
    and timed beside their bounds and SDPA. Returns the kernels-line
    entries (``launches`` filled in by the caller)."""
    import torch

    from production_stack_tpu_torch.probes.common import (
        BF16_FLOPS,
        HBM_BYTES_PER_S,
    )

    bf16 = torch.bfloat16
    B, bs, ctx_len = 8, 64, 2048
    ragged = [2048, 1, 37, 2000, 1500, 64, 65, 1024]
    results = {}
    for i, (suffix, (model, H, KVH, D)) in enumerate(TP_SHAPES.items()):
        seed = 500 + 10 * i
        chunk_prefix, chunk_take, maxb = ((2048, 452, 64) if model == "llama"
                                          else (1024, 877, 32))
        cases = [
            ("paged_attention", "8x2048", decode_case(
                bf16, B, H, KVH, D, 2, bs, ctx_len // bs, [ctx_len] * B,
                seed=seed), None),
            ("paged_attention", "ragged", decode_case(
                bf16, B, H, KVH, D, 2, bs, ctx_len // bs, ragged,
                seed=seed + 1), None),
            ("cached_prefill_attention", "1024/1024", prefill_case(
                bf16, 1, 1024, H, KVH, D, 2, bs, 32, [1024], [1024],
                seed=seed + 2), None),
            ("cached_prefill_attention", "ragged chunk", prefill_case(
                bf16, 1, 1024, H, KVH, D, 2, bs, maxb, [chunk_prefix],
                [chunk_take], seed=seed + 3),
             (slice(None), slice(0, chunk_take))),
        ]
        errs = {}
        for j, (base, label, c, rows) in enumerate(cases):
            name = f"{base}_{suffix}"
            run, plain = KERNELS[name]
            err, _ = check_close(f"{name} {label} (H {H}, KVH {KVH})",
                                 run(c), plain(c), rows)
            # Over long contexts |o| is small and 2e-3 absolute holds too;
            # a ragged row of one token returns its V row (|o| ~ 1), where
            # a bf16 ulp alone is ~8e-3: the row bar holds it.
            if j in (0, 2) and not err <= F32_BAR:
                raise AssertionError(f"{name} {label}: max_abs_err "
                                     f"{err:.3e} above {F32_BAR}")
            errs[name] = max(errs.get(name, 0.0), err)
        timed = {f"paged_attention_{suffix}": _time_decode(
                     f"paged_attention {suffix}", cases[0][2]),
                 f"cached_prefill_attention_{suffix}": _time_prefill(
                     f"cached_prefill {suffix}", cases[2][2])}
        for name, r in timed.items():
            byte_ms = r.pop("bytes") / HBM_BYTES_PER_S * 1e3
            op_ms = r.pop("ops") / BF16_FLOPS * 1e3
            r.update(max_abs_err=errs[name], bound_ms=max(byte_ms, op_ms),
                     bound_by="bytes" if byte_ms >= op_ms else "operations",
                     shape=tp_shape_key(H, KVH, D))
            log(f"[kernel] {name}: {json.dumps(r)}")
            results[name] = r
    return results


# The tp and kv_ranks phases serve Llama-3-8B's widths at this many of
# its 32 layers (--tp-cards serves all 32 at tp 2 and 4).
TP_LLAMA_LAYERS = 4
TP_PARITY_MODEL = "tpu-llama-1b"
TP_PARITY_ARGS = [TP_PARITY_MODEL, "--device", "cuda", "--dtype", "float32",
                  "--host", "127.0.0.1", "--port", "0", "--max-model-len",
                  "2048", "--max-num-seqs", "4", "--seed", "0",
                  "--num-blocks", "256", "--prefill-chunk-size", "256",
                  "--max-loras", "0"]
# Mixtral-8x7B at full width cut to this many of its 32 layers: the tp
# phase's check of split experts (each rank holds 4 of the 8).
TP_MIXTRAL_LAYERS = 4


def _rank_summary(ranks: list) -> list:
    """Each rank's coordinates, layers, device, weight and pool bytes,
    pool blocks, KV heads, kernel launches by shape (the kernels'
    wrappers' own counts) and collective and point-to-point counts."""
    return [{k: r[k] for k in ("rank", "dp", "pp", "tp", "layers", "device",
                               "device_name", "weight_bytes",
                               "kv_pool_bytes", "num_blocks", "kv_heads",
                               "launches_by_shape", "collectives_total",
                               "p2p")}
            for r in ranks]


def _check_ranks(label: str, ranks: list, n: int, shapes) -> None:
    """Every one of the job's ``n`` ranks on the card, and each of
    ``shapes`` (wrapper name -> launch-shape key) launched on every
    rank."""
    if len(ranks) != n:
        raise AssertionError(f"{label}: {len(ranks)} ranks answered")
    for r in ranks:
        if not r["device"].startswith("cuda"):
            raise AssertionError(f"{label}: rank {r['rank']} on "
                                 f"{r['device']}")
        for fn, key in shapes.items():
            if r["launches_by_shape"].get(fn, {}).get(key, 0) <= 0:
                raise AssertionError(
                    f"{label}: rank {r['rank']} launched no {fn} at {key}: "
                    f"{r['launches_by_shape']}")


def tp_decode_profile(core, rows: int = 8, ctx_chars: int = 600) -> dict:
    """A decode step of a sharded engine's leader whose engine thread is
    paused (its followers still replaying), driven on this thread as
    :func:`decode_profile` drives one: ``rows`` sequences at ~``ctx_chars``
    tokens, host time of pipelined bursts (two runs of two bursts, the
    least is the step), every rank's device busy time under its own
    torch.profiler (two bursts; ``rank_stats(profile=...)``), then two
    bursts with every collective and point-to-point transfer synchronized
    and timed on each rank: their share of that step, and each rank's
    kernel launches a step."""
    import torch

    from production_stack_tpu_torch.engine.sampling import SamplingParams

    with core._lock:
        core._running = False
        core._lock.notify()
    core._thread.join(timeout=60)
    for i in range(rows):
        core.add_request(
            f"tprof{i}", core.tokenizer.encode(_text(100 + i, ctx_chars)),
            SamplingParams(temperature=0, max_tokens=400, ignore_eos=True),
            lambda t, f: None)
    K = core.config.decode_steps

    def bursts(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            core._do_decode()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n / K

    with torch.inference_mode():
        while True:
            action, req = core.scheduler.next_action()
            if action != "prefill":
                break
            core._do_prefill(req)
        core._do_decode()
        core._flush_pending_burst()
        runs = [bursts(2) for _ in range(2)]
        core._flush_pending_burst()
        core.rank_stats(profile=True)
        for _ in range(2):
            core._do_decode()
        core._flush_pending_burst()
        busy = core.rank_stats(profile=False)
        core.rank_stats(reset=True, timing=True)
        timed_ms = bursts(2)
        core._flush_pending_burst()
        ranks = core.rank_stats(reset=True, timing=False)
    # Two bursts profiled; the flush reads back, launching nothing more.
    busy_ms = [r["device_busy_s"] * 1e3 / (2 * K) for r in busy]
    step_ms = min(runs)
    coll_ms = [r["collective_s"] * 1e3 / (2 * K) for r in ranks]
    with core._lock:
        for seq in core.scheduler.running():
            core.scheduler.finish(seq, "abort")
    out = {"decode_rows": rows,
           "decode_host_ms_per_step": step_ms,
           "decode_host_ms_per_step_runs": runs,
           "leader_device_busy_ms_per_step": busy_ms[0],
           "leader_device_idle_share": max(0.0, 1.0 - busy_ms[0] / step_ms),
           "device_busy_ms_per_step_by_rank": busy_ms,
           "collectives_per_step": ranks[0]["collectives_total"] / (2 * K),
           "timed_step_ms": timed_ms,
           "collective_ms_per_step_by_rank": coll_ms,
           "collective_share_of_step": max(coll_ms) / timed_ms,
           "decode_launches_per_step_by_rank": [
               sum(r["launches_by_shape"]["paged_attention"].values())
               / (2 * K) for r in ranks]}
    if ranks[0]["p2p"] is not None:
        # One pipeline's sends (tp index 0 of replica 0) and the leader's
        # shares, a step; each rank's transfer time and its share of it.
        first = [r for r in ranks if r["dp"] == 0 and r["tp"] == 0]
        p2p_ms = [(r["p2p"]["p2p_s"] + r["p2p"]["share_s"]) * 1e3 / (2 * K)
                  for r in ranks]
        out.update(
            sends_per_step=sum(r["p2p"]["sends_total"]
                               for r in first) / (2 * K),
            shares_per_step=ranks[0]["p2p"]["shares_total"] / (2 * K),
            p2p_bytes_per_step=sum(r["p2p"]["p2p_bytes"]
                                   for r in first) / (2 * K),
            p2p_ms_per_step_by_rank=p2p_ms,
            p2p_share_of_step=max(p2p_ms) / timed_ms)
    return out


def _tp_serve(label: str, args, drive, shapes, profile_decode=False):
    """Serve ``args`` (with ``--tensor-parallel-size``,
    ``--pipeline-parallel-size`` or ``--data-parallel-size``) through the
    port's server entry, which starts the follower ranks as processes on
    this host; zero every rank's launch counts, ``drive(client)`` it over
    HTTP, read every rank's counts, and check each of ``shapes`` launched
    on every rank. Returns (drive's result, rank summaries, the decode
    profile or None, init seconds)."""
    import threading

    from production_stack_tpu_torch.engine.server import build_server

    import torch

    t0 = time.time()
    httpd, core = build_server(list(args))
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n = core.layout.size
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    client = Client(httpd.server_address[1])
    prof = None
    try:
        # Rank r runs on cuda:(r % cards): ranks share a card, and must
        # use gloo, only when there are fewer cards than ranks.
        want = "gloo" if n > torch.cuda.device_count() else "nccl"
        if core._backend != want:
            raise AssertionError(f"{label}: {n} ranks on "
                                 f"{torch.cuda.device_count()} card(s) "
                                 f"must use {want}, not {core._backend}")
        core.rank_stats(reset=True)
        out = drive(client)
        ranks = core.rank_stats()
        _check_ranks(label, ranks, n, shapes)
        if core.fatal_error is not None:
            raise AssertionError(f"{label}: {core.fatal_error}")
        httpd.shutdown()
        if profile_decode:
            prof = tp_decode_profile(core)
    finally:
        httpd.shutdown()
        httpd.server_close()  # stops the engine and ends the job
        core.stop()
    if core.fatal_error is not None:
        raise AssertionError(f"{label}: {core.fatal_error}")
    log(f"[ranks] {label}: {n} ranks up in {init_s:.1f} s")
    return out, _rank_summary(ranks), prof, init_s


def _tp_llama_drive(client):
    """Llama-3-8B at tp 2, as :func:`serve_phase` drives it: four
    concurrent greedy completions (decode bursts), a ~2,500-token prompt
    (1,024-token chunks through the cached prefill), a prefix hit over
    its first 2,000 characters, and a seeded sampled request sent twice
    (one text)."""
    import threading

    results = [None] * 4

    def run(i):
        results[i] = client.post("/v1/completions", {
            "prompt": _text(i, 50 + 80 * i), "max_tokens": 16,
            "temperature": 0})

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    for i, out in enumerate(results):
        if out is None:
            raise AssertionError(f"tp concurrent request {i}: no reply")
        _finish(f"tp concurrent {i}", out)
    long_prompt = _text(10, 2500)
    long_out = client.post("/v1/completions", {
        "prompt": long_prompt, "max_tokens": 16, "temperature": 0})
    _finish("tp long prompt", long_out)
    hit_out = client.post("/v1/completions", {
        "prompt": long_prompt[:2000] + _text(11, 500), "max_tokens": 16,
        "temperature": 0})
    _finish("tp prefix hit", hit_out)
    seeded = [client.post("/v1/completions", {
        "prompt": _text(50, 40), "max_tokens": 16, "temperature": 0.8,
        "top_p": 0.95, "seed": 1234}) for _ in range(2)]
    for out in seeded:
        _finish("tp seeded", out)
    if seeded[0]["choices"][0]["text"] != seeded[1]["choices"][0]["text"]:
        raise AssertionError("tp: a seeded sampled request gave two texts")
    metrics = client.get("/metrics")
    hits = [ln for ln in metrics.splitlines()
            if ln.startswith("tpu:prefix_cache_hits_total")]
    if not hits or float(hits[0].split()[-1]) <= 0:
        raise AssertionError(f"tp: no prefix-cache hit ({hits})")
    return {"concurrent_latency_s": [r["_latency_s"] for r in results],
            "long_latency_s": long_out["_latency_s"],
            "hit_latency_s": hit_out["_latency_s"],
            "sample_text": results[0]["choices"][0]["text"][:40]}


def _parity_requests():
    """The float32 streams compared across tp sizes, one request at a
    time: greedy completions (one of 600 tokens: three 256-token chunks),
    its prefix hit, and a seeded sampled request."""
    ids = [[(7 * i + 13 * j) % 31000 + 100 for j in range(n)]
           for i, n in enumerate((24, 600, 90))]
    greedy = dict(max_tokens=24, temperature=0)
    return [dict(greedy, prompt=ids[0]), dict(greedy, prompt=ids[1]),
            dict(greedy, prompt=ids[1][:512] + ids[2]),
            dict(max_tokens=24, temperature=0.8, top_p=0.9, seed=77,
                 prompt=ids[2])]


def _parity_drive(client):
    texts = []
    for i, body in enumerate(_parity_requests()):
        out = client.post("/v1/completions", dict(body, logprobs=1))
        _finish(f"tp parity {i}", out)
        texts.append(out["choices"][0]["logprobs"]["tokens"])
    return texts


def _mixtral_tp_dir(here: str) -> str:
    """Mixtral-8x7B's config.json at ``TP_MIXTRAL_LAYERS`` layers in the
    build directory (the server draws the weights from its seed)."""
    path = os.path.join(here, "production_stack_tpu_torch", "_build",
                        "models", f"Mixtral-8x7B-{TP_MIXTRAL_LAYERS}L")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(MIXTRAL_CONFIG,
                       num_hidden_layers=TP_MIXTRAL_LAYERS), f, indent=1)
    return path


def _short_drive(client):
    """Two concurrent greedy completions and a ~1,900-token prompt in
    chunks (decode and cached prefill on every rank)."""
    import threading

    results = [None] * 2

    def run(i):
        results[i] = client.post("/v1/completions", {
            "prompt": _text(60 + i, 120), "max_tokens": 24,
            "temperature": 0})

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    for i, out in enumerate(results):
        if out is None:
            raise AssertionError(f"tp short request {i}: no reply")
        _finish(f"tp short {i}", out)
    out = client.post("/v1/completions", {
        "prompt": _text(70, 1900), "max_tokens": 8, "temperature": 0})
    _finish("tp short long prompt", out)
    return {"sample_text": results[0]["choices"][0]["text"][:40]}


def tp_phase(here: str, smi):
    """Tensor parallelism on the card, every rank a process on the one
    H100 under gloo (NCCL refuses two ranks on one device):

    - Llama-3-8B at full width and ``TP_LLAMA_LAYERS`` layers, bf16,
      random weights from seed 0, at ``--tensor-parallel-size 2`` through
      the server entry, driven as :func:`_tp_llama_drive` says; both
      kernels launched on both ranks at H 16 / KVH 4; then the decode
      step's host and device time and the collectives' share
      (:func:`tp_decode_profile`);
    - tpu-llama-1b in float32 at tp 1, 2 and 4: the same token streams
      (greedy, chunked, a prefix hit, seeded sampled);
    - Mixtral-8x7B at full width, ``TP_MIXTRAL_LAYERS`` layers, tp 2:
      each rank holds 4 of the 8 experts;
    - OPT-125m bf16 at tp 2 and 4 (6 and 3 heads a rank, G 1).

    Returns (bf16 launches summed over ranks by shape, the ``tp``
    summary, the tp 1 float32 streams)."""
    import torch

    summary = {"card": smi, "card_count": torch.cuda.device_count()}
    launches: dict = {}

    def add(ranks):
        for r in ranks:
            for fn, by in r["launches_by_shape"].items():
                for key, n in by.items():
                    launches[(fn, key)] = launches.get((fn, key), 0) + n

    both = ("paged_attention", "cached_prefill_attention")
    _free_device_memory()
    args = ([llama_8b_dir(here, TP_LLAMA_LAYERS)] + SERVE_ARGS[1:]
            + ["--tensor-parallel-size", "2"])
    out, ranks, prof, init_s = _tp_serve(
        f"Llama-3-8B {TP_LLAMA_LAYERS} layers bf16 tp 2", args,
        _tp_llama_drive, {fn: tp_shape_key(16, 4, 128) for fn in both},
        profile_decode=True)
    add(ranks)
    summary["llama_8b_tp2"] = dict(out, init_s=init_s, ranks=ranks,
                                   layers=TP_LLAMA_LAYERS, decode=prof)
    log(f"[tp] Llama-3-8B tp 2: {json.dumps(summary['llama_8b_tp2'])}")

    streams = {}
    for tp in (1, 2, 4):
        _free_device_memory()
        args = TP_PARITY_ARGS + ["--tensor-parallel-size", str(tp)]
        if tp == 1:
            streams[tp] = _serve_once(args, _parity_drive)
            continue
        H, KVH = 16 // tp, 8 // tp
        f32_key = tp_shape_key(H, KVH, 128).replace("bfloat16", "float32")
        streams[tp], ranks, _, init_s = _tp_serve(
            f"{TP_PARITY_MODEL} float32 tp {tp}", args, _parity_drive,
            {fn: f32_key for fn in both})
        summary[f"parity_tp{tp}"] = {"init_s": init_s, "ranks": ranks}
        if streams[tp] != streams[1]:
            raise AssertionError(
                f"{TP_PARITY_MODEL} float32 streams at tp {tp} differ from "
                f"tp 1: {streams[tp]} vs {streams[1]}")
    summary["parity"] = {"model": TP_PARITY_MODEL, "dtype": "float32",
                         "tp": [1, 2, 4], "requests": len(streams[1]),
                         "tokens": sum(len(s) for s in streams[1]),
                         "equal": True}

    _free_device_memory()
    path = _mixtral_tp_dir(here)
    margs = [path] + SERVE_ARGS[1:] + ["--tensor-parallel-size", "2"]
    out, ranks, _, init_s = _tp_serve(
        f"Mixtral-8x7B {TP_MIXTRAL_LAYERS} layers bf16 tp 2", margs,
        _short_drive, {fn: tp_shape_key(16, 4, 128) for fn in both})
    add(ranks)
    summary["mixtral_tp2"] = dict(out, init_s=init_s, ranks=ranks,
                                  layers=TP_MIXTRAL_LAYERS,
                                  experts_per_rank=4)

    for tp in (2, 4):
        _free_device_memory()
        oargs = OPT_ARGS + ["--tensor-parallel-size", str(tp)]
        out, ranks, _, init_s = _tp_serve(
            f"OPT-125m bf16 tp {tp}", oargs, _short_drive,
            {fn: tp_shape_key(12 // tp, 12 // tp, 64) for fn in both})
        add(ranks)
        summary[f"opt_tp{tp}"] = dict(out, init_s=init_s, ranks=ranks)
    return launches, summary, streams[1]


def tp_cards_phase(here: str, smi) -> dict:
    """Tensor parallelism with a card a rank (``--tp-cards``, on a host of
    several cards; NCCL carries the collectives): Llama-3-8B bf16 at tp 2
    and 4 driven as :func:`_tp_llama_drive` says with the decode profile
    (host and device time, the collectives' share); tpu-llama-1b float32
    streams at tp 2 and 4 equal to tp 1's; Mixtral-8x7B at full width and
    all 32 layers at tp 4 (92.9 GB of layers, which no one card holds),
    served and profiled. Returns the ``tp_cards`` summary."""
    import torch

    cards = torch.cuda.device_count()
    sizes = [tp for tp in (2, 4) if tp <= cards]
    if not sizes:
        raise AssertionError(f"--tp-cards needs 2 cards at least, not "
                             f"{cards}")
    both = ("paged_attention", "cached_prefill_attention")
    summary = {"card": smi, "card_count": cards}
    for tp in sizes:
        _free_device_memory()
        out, ranks, prof, init_s = _tp_serve(
            f"Llama-3-8B bf16 tp {tp} on {tp} cards",
            SERVE_ARGS + ["--tensor-parallel-size", str(tp)],
            _tp_llama_drive,
            {fn: tp_shape_key(32 // tp, 8 // tp, 128) for fn in both},
            profile_decode=True)
        summary[f"llama_8b_tp{tp}"] = dict(out, init_s=init_s, ranks=ranks,
                                           decode=prof)
        log(f"[tp] Llama-3-8B tp {tp} on {tp} cards: "
            f"{json.dumps(summary[f'llama_8b_tp{tp}'])}")
    _free_device_memory()
    streams = {1: _serve_once(TP_PARITY_ARGS, _parity_drive)}
    for tp in sizes:
        _free_device_memory()
        f32_key = tp_shape_key(16 // tp, 8 // tp, 128).replace(
            "bfloat16", "float32")
        streams[tp], _, _, _ = _tp_serve(
            f"{TP_PARITY_MODEL} float32 tp {tp} on {tp} cards",
            TP_PARITY_ARGS + ["--tensor-parallel-size", str(tp)],
            _parity_drive, {fn: f32_key for fn in both})
        if streams[tp] != streams[1]:
            raise AssertionError(f"{TP_PARITY_MODEL} float32 streams at tp "
                                 f"{tp} differ from tp 1")
    summary["parity"] = {"model": TP_PARITY_MODEL, "dtype": "float32",
                         "tp": [1] + sizes, "equal": True}
    if 4 in sizes:
        _free_device_memory()
        path = os.path.join(here, "production_stack_tpu_torch", "_build",
                            "models", "Mixtral-8x7B-32L")
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(dict(MIXTRAL_CONFIG, num_hidden_layers=32), f)
        out, ranks, prof, init_s = _tp_serve(
            "Mixtral-8x7B 32 layers bf16 tp 4 on 4 cards",
            [path] + SERVE_ARGS[1:] + ["--tensor-parallel-size", "4"],
            _short_drive, {fn: tp_shape_key(8, 2, 128) for fn in both},
            profile_decode=True)
        summary["mixtral_32l_tp4"] = dict(out, init_s=init_s, ranks=ranks,
                                          decode=prof)
    return summary


def _serve_once(args, drive):
    """``drive(client)`` of one single-rank server of ``args``."""
    import threading

    from production_stack_tpu_torch.engine.server import build_server

    httpd, core = build_server(list(args))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        return drive(Client(httpd.server_address[1]))
    finally:
        httpd.shutdown()
        httpd.server_close()
        core.stop()


# -- pipeline and data parallelism ------------------------------------------

# The pp phase serves Llama-3-8B's widths at this many of its 32 layers
# at pp 2 (2 a stage); --pp-cards serves all 32.
PP_LLAMA_LAYERS = 4
# tpu-llama-1b float32 runs whose streams are held to tp 1's: (label,
# extra arguments, launch shape (H, KVH) of a rank's kernels).
PP_PARITY_RUNS = (
    ("pp 2", ["--pipeline-parallel-size", "2"], (16, 8)),
    ("pp 4, one microbatch", ["--pipeline-parallel-size", "4",
                              "--pp-microbatches", "1"], (16, 8)),
    ("pp 4", ["--pipeline-parallel-size", "4"], (16, 8)),
    ("pp 2 x tp 2", ["--pipeline-parallel-size", "2",
                     "--tensor-parallel-size", "2"], (8, 4)),
    ("dp 2", ["--data-parallel-size", "2"], (16, 8)))
# The standalone schedule and ring on the card: an MLP stack at
# Llama-3-8B's widths, and ring attention at its heads over 4,096 tokens.
PP_STANDALONE = dict(L=4, M=4, T=64, d=4096, hidden=14336, ring_T=4096,
                     H=32, KVH=8, D=128)
PP_STANDALONE_BAR = 1e-5  # float32 ops against their plain versions
PP_DEVICE = "cuda:0"  # the standalone ranks' device ("cpu": a rehearsal)
# What one transfer costs on its own: a decode microbatch's activations
# (4 rows of Llama-3-8B's hidden state) exchanged between the two ranks,
# and 8 rows shared from the last stage, bf16, timed over this many.
PP_TRANSFER_ITERS = 50


def llama_stage_bytes(cfg, pp: int, lora_slots: int = 8,
                      lora_rank: int = 16) -> int:
    """Weight bytes a pipeline stage of a Llama-family ``cfg`` holds: its
    L/pp layers (attention, MLP, two norms, LoRA slots) and the whole
    embedding, final norm and head, in the model dtype."""
    import torch

    Hd, H, KVH, D, I = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, cfg.intermediate_size)
    layer = (2 * Hd * H * D + 2 * Hd * KVH * D + 3 * Hd * I + 2 * Hd
             + lora_slots * lora_rank * (2 * Hd + H * D + KVH * D))
    whole = 2 * cfg.vocab_size * Hd + Hd
    item = torch.empty((), dtype=cfg.torch_dtype).element_size()
    return (cfg.num_layers // pp * layer + whole) * item + lora_slots * 4


def _check_stages(label: str, ranks: list, pp: int, layers: int,
                  want_bytes: int) -> None:
    """Every rank holds its stage's ``layers / pp`` layers (in stage
    order) and ``want_bytes`` of weights."""
    per = layers // pp
    for r in ranks:
        if r["layers"] != [r["pp"] * per, (r["pp"] + 1) * per]:
            raise AssertionError(f"{label}: rank {r['rank']} holds layers "
                                 f"{r['layers']}")
        if r["weight_bytes"] != want_bytes:
            raise AssertionError(f"{label}: rank {r['rank']} holds "
                                 f"{r['weight_bytes']} B of weights, not "
                                 f"{want_bytes}")


_PP_STANDALONE_WORKER = r"""
import os, sys, time
import torch
import torch.distributed as dist
sys.path.insert(0, os.environ["PP_REPO"])
import chip_smoke
from production_stack_tpu_torch.parallel.pipeline import (
    pipeline_forward, stage_params)
from production_stack_tpu_torch.parallel.pp import PPGroup
from production_stack_tpu_torch.parallel.ring_attention import (
    make_ring_attention)

rank, out = int(os.environ["PP_RANK"]), os.environ["PP_OUT"]
dist.init_process_group(
    "gloo", init_method="tcp://127.0.0.1:" + os.environ["PP_PORT"],
    world_size=2, rank=rank)
dev = torch.device(os.environ["PP_DEVICE"])
if dev.type == "cuda":
    torch.cuda.set_device(dev)
group = PPGroup.create([0, 1], dev)
inputs = torch.load(os.path.join(out, "inputs.pt"))
params = {k: v.to(dev) for k, v in inputs["params"].items()}
run = pipeline_forward(chip_smoke.pp_mlp_layer, group)
y = run(stage_params(params, group.stage, 2), inputs["x"].to(dev))
ring = make_ring_attention(group, inputs["scale"])
o = ring(*(inputs[n].to(dev) for n in "qkv"))
counters = group.counters()


def per_call_ms(fn, n):
    for _ in range(5):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3 / n


n = int(os.environ["PP_ITERS"])
act = torch.randn((4, 1, 4096), device=dev).to(torch.bfloat16)
hidden = torch.randn((8, 1, 4096), device=dev).to(torch.bfloat16)
transfer_ms = {"exchange_4x4096_bf16": per_call_ms(lambda: group.rotate(act),
                                                   n),
               "share_8x4096_bf16": per_call_ms(
                   lambda: group.share_last(hidden.clone()), n)}
torch.save({"pipeline": y.cpu(), "ring": o.cpu(), "counters": counters,
            "backend": group.backend, "staged": group.staged,
            "transfer_ms": transfer_ms},
           os.path.join(out, "rank%d.pt" % rank))
dist.destroy_process_group()
"""


def pp_mlp_layer(x, p):
    """The standalone schedule's layer (``tests/test_pipeline.py``'s)."""
    import torch

    h = torch.tanh(x @ p["w1"] + p["b1"])
    return x + h @ p["w2"]


def pp_standalone_phase(here: str) -> dict:
    """``parallel/pipeline.py::pipeline_forward`` and
    ``parallel/ring_attention.py::make_ring_attention`` on 2 ranks, each
    a process on this card (gloo), against their single-process plain
    versions on the card (``reference_forward``,
    ``reference_causal_attention``), float32, at ``PP_STANDALONE``'s
    shapes; every rank's output within ``PP_STANDALONE_BAR``. Then what
    one transfer costs alone (``PP_TRANSFER_ITERS`` of each, host ms a
    call with the card synchronized): a decode microbatch's activations
    exchanged (``PPGroup.rotate``, the staging of ``send_next`` and
    ``recv_prev`` both ways) and 8 rows shared (``share_last``)."""
    import subprocess

    import torch

    from production_stack_tpu_torch.parallel.multihost import _free_port_pair
    from production_stack_tpu_torch.parallel.pipeline import (
        reference_forward,
    )
    from production_stack_tpu_torch.parallel.ring_attention import (
        reference_causal_attention,
    )

    c = PP_STANDALONE
    g = torch.Generator().manual_seed(0)

    def normal(*shape, std=1.0):
        return torch.randn(shape, generator=g) * std

    d, hid, L = c["d"], c["hidden"], c["L"]
    inputs = {
        "params": {"w1": normal(L, d, hid, std=d ** -0.5),
                   "b1": normal(L, hid, std=0.1),
                   "w2": normal(L, hid, d, std=hid ** -0.5)},
        "x": normal(c["M"], c["T"], d),
        "q": normal(1, c["ring_T"], c["H"], c["D"]),
        "k": normal(1, c["ring_T"], c["KVH"], c["D"]),
        "v": normal(1, c["ring_T"], c["KVH"], c["D"]),
        "scale": c["D"] ** -0.5}
    out = os.path.join(here, "production_stack_tpu_torch", "_build",
                       "pp_standalone")
    os.makedirs(out, exist_ok=True)
    torch.save(inputs, os.path.join(out, "inputs.pt"))
    port = _free_port_pair()
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PP_STANDALONE_WORKER],
        env=dict(os.environ, PP_REPO=here, PP_OUT=out, PP_PORT=str(port),
                 PP_RANK=str(rank), PP_DEVICE=PP_DEVICE,
                 PP_ITERS=str(PP_TRANSFER_ITERS)))
        for rank in range(2)]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        raise AssertionError(f"pp standalone ranks exited with {codes}")
    wall_s = time.time() - t0
    dev = torch.device(PP_DEVICE)
    params = {k: v.to(dev) for k, v in inputs["params"].items()}
    want = {"pipeline": reference_forward(pp_mlp_layer)(
                params, inputs["x"].to(dev)).cpu(),
            "ring": reference_causal_attention(
                *(inputs[n].to(dev) for n in "qkv"),
                scale=inputs["scale"]).cpu()}
    report = {"shapes": c, "wall_s": wall_s, "ranks": []}
    for rank in range(2):
        got = torch.load(os.path.join(out, f"rank{rank}.pt"))
        errs = {k: float((got[k] - want[k]).abs().max()) for k in want}
        for k, err in errs.items():
            if not err <= PP_STANDALONE_BAR:
                raise AssertionError(f"pp standalone {k} on rank {rank}: "
                                     f"max_abs_err {err:.3e} above "
                                     f"{PP_STANDALONE_BAR}")
        report["ranks"].append(dict(rank=rank, max_abs_err=errs,
                                    backend=got["backend"],
                                    staged=got["staged"],
                                    transfer_ms=got["transfer_ms"],
                                    counters=got["counters"]))
    shutil.rmtree(out, ignore_errors=True)
    log(f"[pp] standalone: {json.dumps(report)}")
    return report


def pp_phase(here: str, smi, tp1_streams) -> tuple:
    """Pipeline and data parallelism on the card, every rank a process on
    the one H100 under gloo (activations staged through pinned host
    memory, the share a gloo broadcast):

    - Llama-3-8B at full width and ``PP_LLAMA_LAYERS`` = 4 of its 32
      layers, bf16, random weights from seed 0, at
      ``--pipeline-parallel-size 2`` through the server entry, driven as
      :func:`_tp_llama_drive` says: each stage holds 2 layers and the
      whole embedding and head (:func:`llama_stage_bytes`), both kernels
      launched on both stages at 32/8 heads; then the decode step at 8
      rows (:func:`tp_decode_profile`): host ms a step, each stage's
      device busy, the transfers a step and their share, and 2 decode
      launches a stage a microbatch of each step;
    - tpu-llama-1b in float32 at each of ``PP_PARITY_RUNS``: the tp
      phase's tp 1 streams (greedy, chunked, a prefix hit, seeded
      sampled), token for token;
    - :func:`pp_standalone_phase`.

    Returns (bf16 launches summed over ranks by (wrapper, shape), the
    ``pp`` summary)."""
    import torch

    from production_stack_tpu_torch.models import get_model_config

    summary = {"card": smi, "card_count": torch.cuda.device_count()}
    launches: dict = {}
    both = ("paged_attention", "cached_prefill_attention")
    cfg = get_model_config("meta-llama/Llama-3-8B").replace(
        num_layers=PP_LLAMA_LAYERS)
    want_bytes = llama_stage_bytes(cfg, 2)
    _free_device_memory()
    args = ([llama_8b_dir(here, PP_LLAMA_LAYERS)] + SERVE_ARGS[1:]
            + ["--pipeline-parallel-size", "2"])
    out, ranks, prof, init_s = _tp_serve(
        "Llama-3-8B bf16 pp 2", args, _tp_llama_drive,
        {fn: tp_shape_key(32, 8, 128) for fn in both}, profile_decode=True)
    _check_stages("Llama-3-8B bf16 pp 2", ranks, 2, cfg.num_layers,
                  want_bytes)
    for r in ranks:
        for fn, by in r["launches_by_shape"].items():
            for key, n in by.items():
                launches[(fn, key)] = launches.get((fn, key), 0) + n
    # 8 rows at the default microbatches (pp): 2 microbatches a step.
    M = 2
    for n in prof["decode_launches_per_step_by_rank"]:
        if n != cfg.num_layers // 2 * M:
            raise AssertionError(f"Llama-3-8B pp 2: {n} decode launches a "
                                 f"stage a step, not "
                                 f"{cfg.num_layers // 2} x {M}")
    summary["llama_8b_pp2"] = dict(
        out, init_s=init_s, ranks=ranks, decode=prof, microbatches=M,
        stage_weight_bytes=want_bytes)
    log(f"[pp] Llama-3-8B pp 2: {json.dumps(summary['llama_8b_pp2'])}")

    for label, extra, (H, KVH) in PP_PARITY_RUNS:
        _free_device_memory()
        f32_key = tp_shape_key(H, KVH, 128).replace("bfloat16", "float32")
        streams, ranks, _, init_s = _tp_serve(
            f"{TP_PARITY_MODEL} float32 {label}", TP_PARITY_ARGS + extra,
            _parity_drive, {fn: f32_key for fn in both})
        if streams != tp1_streams:
            raise AssertionError(
                f"{TP_PARITY_MODEL} float32 streams at {label} differ from "
                f"tp 1: {streams} vs {tp1_streams}")
        summary[f"parity {label}"] = {
            "init_s": init_s, "ranks": len(ranks),
            "coords": [(r["dp"], r["pp"], r["tp"]) for r in ranks],
            "layers": [r["layers"] for r in ranks]}
    summary["parity"] = {"model": TP_PARITY_MODEL, "dtype": "float32",
                         "runs": [r[0] for r in PP_PARITY_RUNS],
                         "requests": len(tp1_streams),
                         "tokens": sum(len(s) for s in tp1_streams),
                         "equal_to_tp1": True}
    _free_device_memory()
    summary["standalone"] = pp_standalone_phase(here)
    return launches, summary


def pp_cards_phase(here: str, smi) -> dict:
    """Pipeline parallelism with a card a stage (``--tp-cards`` and
    ``--pp-cards``, on a host of several cards; NCCL carries the
    point-to-point and the share): Llama-3-8B bf16 at pp 2 and 4 driven
    as :func:`_tp_llama_drive` says with the decode profile; tpu-llama-1b
    float32 streams at pp 2 and 4 equal to pp 1's; then
    :func:`pp_70b_phase`. Returns the ``pp_cards`` summary."""
    import torch

    from production_stack_tpu_torch.models import get_model_config

    cards = torch.cuda.device_count()
    sizes = [pp for pp in (2, 4) if pp <= cards]
    if not sizes:
        raise AssertionError(f"--pp-cards needs 2 cards at least, not "
                             f"{cards}")
    both = ("paged_attention", "cached_prefill_attention")
    summary = {"card": smi, "card_count": cards}
    cfg = get_model_config("meta-llama/Llama-3-8B")
    for pp in sizes:
        _free_device_memory()
        label = f"Llama-3-8B bf16 pp {pp} on {pp} cards"
        out, ranks, prof, init_s = _tp_serve(
            label, SERVE_ARGS + ["--pipeline-parallel-size", str(pp)],
            _tp_llama_drive, {fn: tp_shape_key(32, 8, 128) for fn in both},
            profile_decode=True)
        _check_stages(label, ranks, pp, cfg.num_layers,
                      llama_stage_bytes(cfg, pp))
        summary[f"llama_8b_pp{pp}"] = dict(out, init_s=init_s, ranks=ranks,
                                           decode=prof)
        log(f"[pp] {label}: {json.dumps(summary[f'llama_8b_pp{pp}'])}")
    _free_device_memory()
    streams = {1: _serve_once(TP_PARITY_ARGS, _parity_drive)}
    f32_key = tp_shape_key(16, 8, 128).replace("bfloat16", "float32")
    for pp in sizes:
        _free_device_memory()
        streams[pp], _, _, _ = _tp_serve(
            f"{TP_PARITY_MODEL} float32 pp {pp} on {pp} cards",
            TP_PARITY_ARGS + ["--pipeline-parallel-size", str(pp)],
            _parity_drive, {fn: f32_key for fn in both})
        if streams[pp] != streams[1]:
            raise AssertionError(f"{TP_PARITY_MODEL} float32 streams at pp "
                                 f"{pp} differ from pp 1")
    summary["parity"] = {"model": TP_PARITY_MODEL, "dtype": "float32",
                         "pp": [1] + sizes, "equal": True}
    if 4 in sizes:
        summary.update(pp_70b_phase(smi))
    return summary


def pp_70b_phase(smi) -> dict:
    """Llama-3-70B's shapes at pp 4 with a card a stage (``--pp-70b``
    alone, or the end of ``--pp-cards``): 20 of its 80 layers a card
    (38.56 GB of weights a card, 141 GB in all, which no one card holds),
    served as :func:`_short_drive` says and profiled. The init draws each
    stacked leaf whole (a ``w_gate`` is 37.6 GB) before a stage keeps its
    layers; the card's allocator runs with expandable segments (set by
    :func:`main` before the first allocation) so that transient fits."""
    import torch

    from production_stack_tpu_torch.models import get_model_config

    if torch.cuda.device_count() < 4:
        raise AssertionError("Llama-3-70B at pp 4 needs 4 cards")
    both = ("paged_attention", "cached_prefill_attention")
    _free_device_memory()
    big = get_model_config("meta-llama/Llama-3-70B")
    label = "Llama-3-70B bf16 pp 4 on 4 cards"
    out, ranks, prof, init_s = _tp_serve(
        label, ["meta-llama/Llama-3-70B"] + SERVE_ARGS[1:]
        + ["--pipeline-parallel-size", "4"], _short_drive,
        {fn: tp_shape_key(64, 8, 128) for fn in both}, profile_decode=True)
    _check_stages(label, ranks, 4, big.num_layers, llama_stage_bytes(big, 4))
    out = dict(out, init_s=init_s, ranks=ranks, decode=prof,
               model_weight_bytes=sum(r["weight_bytes"] for r in ranks))
    log(f"[pp] {label}: {json.dumps(out)}")
    return {"llama_70b_pp4": out}


# -- KV movement and the lifecycle across ranks; the KV device pipe --------

# Llama-3-8B's widths at TP_LLAMA_LAYERS layers, 64-token pages: a pool
# of 64 blocks, so that two other 2,064-token prompts evict a first one's
# 32 cached blocks to the host tier.
KVR_ARGS = ["--device", "cuda", "--host", "127.0.0.1", "--max-model-len",
            "2304", "--max-num-seqs", "4", "--seed", "0", "--num-blocks",
            "64", "--max-loras", "0"]
KVR_PREFIX = 2048  # tokens: the 32 blocks an extract or a pull moves
KVR_MAX_TOKENS = 16
# tpu-llama-1b float32: the prompt whose 9 cached blocks are extracted.
KVR_F32_PROMPT = 600


_PIPE_PROBE: dict = {}


def start_pipe_probe() -> None:
    """Start the KV device pipe's availability probe (two throwaway
    processes on the card, ~20 s) on a thread, once, so that it runs
    beside the phases before the first one that needs the pipe."""
    import threading

    from production_stack_tpu_torch.kv.device_pipe import (
        device_pipe_available,
    )

    if "thread" in _PIPE_PROBE:
        return

    def run():
        t0 = time.perf_counter()
        _PIPE_PROBE["available"] = device_pipe_available()
        _PIPE_PROBE["seconds"] = time.perf_counter() - t0

    _PIPE_PROBE["thread"] = threading.Thread(target=run, daemon=True)
    _PIPE_PROBE["thread"].start()


def pipe_probe() -> dict:
    """The probe's result, once it has ended; fails when the pipe is
    unavailable on the card."""
    start_pipe_probe()
    _PIPE_PROBE["thread"].join(timeout=300)
    if not _PIPE_PROBE.get("available"):
        raise AssertionError(f"the KV device pipe is unavailable on the "
                             f"card ({_PIPE_PROBE})")
    return {k: v for k, v in _PIPE_PROBE.items() if k != "thread"}


def _kvr_ids(seed: int, n: int = KVR_PREFIX + 16, vocab: int = 30000):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [int(t) for t in rng.integers(100, vocab, size=n)]


def _greedy_ids(core, ids, max_tokens=KVR_MAX_TOKENS):
    """The greedy token ids of one request on ``core`` (its engine thread
    runs it), ending in the finish reason."""
    import queue

    from production_stack_tpu_torch.engine.sampling import SamplingParams

    q: "queue.Queue" = queue.Queue()
    core.add_request(f"kvr-{time.monotonic_ns()}", list(ids),
                     SamplingParams(temperature=0.0, max_tokens=max_tokens,
                                    ignore_eos=True),
                     lambda t, f: q.put((t, f)))
    out = []
    while True:
        t, f = q.get(timeout=600)
        if t is not None:
            out.append(int(t if isinstance(t, int) else t[0]))
        if f is not None:
            if f not in ("stop", "length"):
                raise AssertionError(f"kv_ranks: a request ended {f!r}")
            return out


def _leaf_list(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _same_bits(name, a, b):
    """Two payloads' hashes and every page leaf bit for bit."""
    import torch

    if a["hashes"] != b["hashes"]:
        raise AssertionError(f"kv_ranks: {name}: the hashes differ")
    for side in ("k", "v"):
        for x, y in zip(_leaf_list(a[side]), _leaf_list(b[side])):
            if x.shape != y.shape or x.dtype != y.dtype or not torch.equal(
                    x.view(-1).view(torch.uint8),
                    y.view(-1).view(torch.uint8)):
                raise AssertionError(f"kv_ranks: {name}: {side} pages "
                                     f"differ")


def _payload_bytes(p) -> int:
    return sum(t.numel() * t.element_size()
               for side in ("k", "v") for t in _leaf_list(p[side]))


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _start(args):
    """A port server of ``args`` on a thread of this process."""
    import threading

    from production_stack_tpu_torch.engine.server import build_server

    httpd, core = build_server(list(args) + ["--port", "0"])
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    return httpd, core, Client(httpd.server_address[1])


def _stop(httpd, core):
    httpd.shutdown()
    httpd.server_close()  # ends a sharded engine's job
    core.stop()


def _kvr_tp2_drive(a_core, b_core, summary):
    """The tp 2 engine ``a_core`` (host tier on) and the tp 1 engine
    ``b_core`` of the same weights, both Llama-3-8B at 4 layers, bf16
    pages. Every stream held equal is served over pages whose bits that
    engine computed itself, so no bf16 near-tie between tp 1's and tp 2's
    sums can flip it."""
    P, Q1, Q2, R = (_kvr_ids(s) for s in (301, 302, 303, 304))
    a_fresh = _greedy_ids(a_core, P)
    a_hit = _greedy_ids(a_core, P)
    # Extract at tp 2: every rank's heads to pinned memory, the follower's
    # over gloo to the leader, which assembles the whole blocks.
    before = a_core.rank_stats()
    pa, extract_s = _timed(lambda: a_core.extract_kv(P))
    ranks = a_core.rank_stats()
    if pa is None or len(pa["hashes"]) != KVR_PREFIX // 64:
        raise AssertionError("kv_ranks: the tp 2 extract missed")
    nbytes = _payload_bytes(pa)
    summary["extract_tp2"] = {
        "blocks": len(pa["hashes"]), "bytes": nbytes,
        "seconds": extract_s, "gb_per_s": nbytes / extract_s / 1e9,
        "copy_ms_by_rank": [(r["kv_gather_copy_s"] - b["kv_gather_copy_s"])
                            * 1e3 for r, b in zip(ranks, before)],
        "gloo_ms_by_rank": [(r["kv_gather_gloo_s"] - b["kv_gather_gloo_s"])
                            * 1e3 for r, b in zip(ranks, before)]}
    # Into the tp 1 engine, and back out bit for bit.
    n, inject_s = _timed(lambda: b_core.inject_kv(pa["hashes"], pa["k"],
                                                  pa["v"]))
    pa2 = b_core.extract_kv(P)
    _same_bits("tp 2 -> tp 1 -> extract", pa, pa2)
    b_over_a = _greedy_ids(b_core, P)
    summary["inject_tp1"] = {"blocks": n, "seconds": inject_s,
                             "cross_stream_equal_to_tp2_hit":
                                 b_over_a == a_hit}
    # The host tier at tp 2: two other prompts evict P's 32 blocks, which
    # every rank spills into its own store; P then comes back restored.
    before = a_core.stats()["offload"]
    for ids in (Q1, Q2):
        _greedy_ids(a_core, ids)
    ranks = a_core.rank_stats()
    stores = [r["offload_keys"] for r in ranks]
    if any(s != stores[0] for s in stores) or not set(pa["hashes"]) <= set(
            stores[0]):
        raise AssertionError("kv_ranks: the ranks' host stores differ, or "
                             "miss the spilled prefix")
    restored = _greedy_ids(a_core, P)
    after = a_core.stats()["offload"]
    if restored != a_hit or after["hits"] - before["hits"] < 32:
        raise AssertionError(f"kv_ranks: the restored stream differs, or "
                             f"{after['hits'] - before['hits']} restores")
    summary["host_tier_tp2"] = {
        "store_blocks_by_rank": [len(s) for s in stores],
        "stores_equal": True, "restored_blocks": after["hits"]
        - before["hits"], "stream_equal": True}
    # Sleep and wake at tp 2: every rank stages its weights and drops its
    # pool; after the wake, the pages from tp 1 go back in (8 chunks of 4
    # blocks, each rank writing its heads) and serve P's stream.
    free0 = torch_free()
    _, sleep_s = _timed(a_core.sleep)
    ranks = a_core.rank_stats()  # after every rank's sleep op
    free1 = torch_free()
    _, wake_s = _timed(a_core.wake_up)
    n2 = a_core.inject_kv(pa2["hashes"], pa2["k"], pa2["v"])
    after_wake = _greedy_ids(a_core, P)
    if n2 != 32 or after_wake != a_hit:
        raise AssertionError("kv_ranks: after the wake, the injected pages "
                             "did not give the stream before it")
    summary["lifecycle_tp2"] = {
        "sleep_s": sleep_s, "wake_s": wake_s,
        "freed_bytes_by_rank": [r["sleep_freed_bytes"] for r in ranks],
        "card_free_gain_bytes": free1 - free0, "injected_after_wake": n2,
        "stream_equal": True}
    # The reverse: tp 1's pages into tp 2 and back out bit for bit, then
    # into the tp 1 engine emptied by a sleep, where they serve its own
    # prefix-hit stream.
    _greedy_ids(b_core, R)
    b_hit = _greedy_ids(b_core, R)
    pb = b_core.extract_kv(R)
    n3, inject2_s = _timed(lambda: a_core.inject_kv(pb["hashes"], pb["k"],
                                                    pb["v"]))
    pb2 = a_core.extract_kv(R)
    _same_bits("tp 1 -> tp 2 -> extract", pb, pb2)
    b_core.sleep()
    b_core.wake_up()
    b_core.inject_kv(pb2["hashes"], pb2["k"], pb2["v"])
    if _greedy_ids(b_core, R) != b_hit:
        raise AssertionError("kv_ranks: tp 1's pages back from tp 2 did not "
                             "give tp 1's prefix-hit stream")
    summary["inject_tp2"] = {"blocks": n3, "seconds": inject2_s,
                             "round_trip_bit_equal": True,
                             "stream_equal": True}
    summary["streams"] = {"tp2_fresh_equal_hit": a_fresh == a_hit}


def torch_free() -> int:
    import torch

    torch.cuda.synchronize()
    return int(torch.cuda.mem_get_info()[0])


def _kvr_pipe_drive(b_httpd, b_core, peer_url, summary):
    """The pipe between two server processes on the card: the peer
    computes S's pages, ``b`` pulls them (``kv_path: "device"``, then the
    host relay after a sleep empties its pool, then the pipe again), and
    serves S over them: first-token time, and the same stream each
    time."""
    from production_stack_tpu_torch.probes.common import HBM_BYTES_PER_S

    S = _kvr_ids(305)
    peer = Client(int(peer_url.rsplit(":", 1)[1]))
    mine = Client(b_httpd.server_address[1])
    body = {"prompt": S, "max_tokens": KVR_MAX_TOKENS, "temperature": 0}
    _finish("kv_ranks peer", peer.post("/v1/completions", body))
    runs = []
    for i, kv_path in enumerate(("device", "host", "device")):
        if i:
            b_core.sleep()  # an empty pool: the next pull moves every page
            b_core.wake_up()
        status, out = _status(mine, "/kv/pull", {
            "source_url": peer_url, "request": {"prompt": S},
            "kv_path": kv_path})
        if status != 200 or out.get("status") != "ok":
            raise AssertionError(f"kv_ranks: {kv_path} pull {status} {out}")
        if out["transfer"]["path"] != kv_path:
            raise AssertionError(f"kv_ranks: a {kv_path} pull ran the "
                                 f"{out['transfer']['path']} rung")
        if out["injected_blocks"] != KVR_PREFIX // 64:
            raise AssertionError(f"kv_ranks: {kv_path} pull installed "
                                 f"{out['injected_blocks']} blocks")
        streamed = mine.post("/v1/completions", dict(body, stream=True),
                             stream=True)
        _finish(f"kv_ranks after a {kv_path} pull", streamed)
        runs.append(dict(out["transfer"],
                         first_token_s=streamed["_first_token_s"],
                         stream=_greedy_ids(b_core, S)))
    streams = [r.pop("stream") for r in runs]
    if any(s != streams[0] for s in streams):
        raise AssertionError("kv_ranks: the streams after the device pulls "
                             "differ from the relay's")
    nbytes = runs[0]["bytes"]
    summary["pipe"] = {
        "path": runs[0]["path"], "bytes": nbytes,
        "bound_ms": 2 * nbytes / HBM_BYTES_PER_S * 1e3,
        "device": [runs[0], runs[2]], "host_relay": runs[1],
        "copy_gb_per_s": [nbytes / (r["copy_ms"] / 1e3) / 1e9
                          for r in (runs[0], runs[2])],
        "streams_equal_to_relay": True}


def _kvr_f32_extracts(summary):
    """tpu-llama-1b in float32 at tp 1, pp 2 (float32 pages: the payload
    bit-equal to tp 1's) and pp 2 x tp 2 (int8 pages: codes within one of
    tp 1's, its ranks adding their partial sums in another order)."""
    import torch

    ids = _kvr_ids(306, KVR_F32_PROMPT, 32000)
    both = ("paged_attention", "cached_prefill_attention")
    got = {}
    for label, extra, heads in (
            ("tp 1", [], None), ("tp 1 int8", ["--kv-cache-dtype", "int8"],
                                 None),
            ("pp 2", ["--pipeline-parallel-size", "2"], (16, 8, False)),
            ("pp 2 x tp 2 int8", ["--pipeline-parallel-size", "2",
                                  "--tensor-parallel-size", "2",
                                  "--kv-cache-dtype", "int8"], (8, 4, True))):
        _free_device_memory()
        t0 = time.time()
        at = TP_PARITY_ARGS.index("--port")
        httpd, core, _ = _start(TP_PARITY_ARGS[:at] + TP_PARITY_ARGS[at + 2:]
                                + extra)
        try:
            if heads:
                core.rank_stats(reset=True)
            stream = _greedy_ids(core, ids)
            payload = core.extract_kv(ids)
            if heads:
                from production_stack_tpu_torch.ops.paged_attention import (
                    launch_shape,
                )

                H, KVH, int8 = heads
                key = launch_shape(H, KVH, 128, torch.float32, int8)
                _check_ranks(f"{TP_PARITY_MODEL} {label}", core.rank_stats(),
                             core.layout.size, {fn: key for fn in both})
        finally:
            _stop(httpd, core)
        got[label] = (payload, stream, time.time() - t0)
    _same_bits("pp 2 against tp 1", got["tp 1"][0], got["pp 2"][0])
    ref, mix = got["tp 1 int8"][0], got["pp 2 x tp 2 int8"][0]
    if ref["hashes"] != mix["hashes"]:
        raise AssertionError("kv_ranks: pp 2 x tp 2 hashes differ")
    flips = total = 0
    scale_rel = 0.0
    for side in ("k", "v"):
        d = (mix[side][0].int() - ref[side][0].int()).abs()
        if int(d.max()) > 1:
            raise AssertionError(f"kv_ranks: pp 2 x tp 2 {side} codes differ "
                                 f"by {int(d.max())}")
        flips += int((d != 0).sum())
        total += d.numel()
        scale_rel = max(scale_rel, float(
            ((mix[side][1] - ref[side][1]).abs() / ref[side][1]).max()))
    summary["f32_extracts"] = {
        "model": TP_PARITY_MODEL, "blocks": len(ref["hashes"]),
        "pp2_bit_equal_to_tp1": True,
        "pp2_stream_equal": got["pp 2"][1] == got["tp 1"][1],
        "pp2xtp2_int8_code_flips": flips, "pp2xtp2_int8_codes": total,
        "pp2xtp2_int8_scale_max_rel_diff": scale_rel,
        "pp2xtp2_stream_equal_to_tp1_int8":
            got["pp 2 x tp 2 int8"][1] == got["tp 1 int8"][1],
        "seconds": {k: v[2] for k, v in got.items()}}


def kv_ranks_phase(here: str, smi) -> tuple:
    """KV movement and the lifecycle across ranks, and the KV device pipe
    (a ``{"kv_ranks": ...}`` line):

    - Llama-3-8B at full width and ``TP_LLAMA_LAYERS`` layers, bf16,
      64-token pages, random weights from seed 0: a tp 2 engine (both
      ranks on the card under gloo, a host tier on) and a tp 1 engine of
      the same weights, driven as :func:`_kvr_tp2_drive` says: a
      2,048-token prefix extracted at tp 2 (gather ms by rank and by
      gloo), injected at tp 1 and back; spilled to every rank's store and
      restored; sleep (bytes freed by each rank) and wake (seconds); both
      attention kernels at a rank's 16/4 heads on both ranks;
    - two server processes on the card, the tp 1 engine pulling the
      other's prefix through the KV device pipe (CUDA IPC), through the
      host relay, and through the pipe again (:func:`_kvr_pipe_drive`);
    - tpu-llama-1b in float32 at pp 2 and pp 2 x tp 2
      (:func:`_kvr_f32_extracts`).

    Returns (launches by (wrapper, shape) of the tp 2 ranks and the tp 1
    engine, the summary)."""
    import socket

    t_phase = time.time()
    summary = {"card": smi, "layers": TP_LLAMA_LAYERS, "block_size": 64,
               "prefix_tokens": KVR_PREFIX}
    path = llama_8b_dir(here, TP_LLAMA_LAYERS)
    args = [path] + KVR_ARGS
    _free_device_memory()
    # The pipe's sender: a server process of its own, started first (it
    # loads while this process drives the ranks). The availability probe
    # runs in this process, the puller's (:func:`start_pipe_probe`).
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    err_path = os.path.join(here, "production_stack_tpu_torch", "_build",
                            "kv_ranks_peer.log")
    os.makedirs(os.path.dirname(err_path), exist_ok=True)
    err = open(err_path, "w")
    peer = subprocess.Popen(
        [sys.executable, "-m", "production_stack_tpu_torch.engine.server"]
        + args + ["--port", str(port)], cwd=here, stdout=subprocess.DEVNULL,
        stderr=err, env=dict(os.environ, PYTHONPATH=here,
                             TPU_STACK_KV_DEVICE_PIPE="1"))
    start_pipe_probe()
    launches: dict = {}
    b = a = None
    try:
        # tp 1 first: a job's environment (the tp 2 ranks') must not be
        # in place when a single-rank engine is built.
        b = _start(args)
        a = _start(args + ["--tensor-parallel-size", "2",
                           "--kv-offload-gb", "1"])
        a_httpd, a_core, _ = a
        parts = {"engines_up": time.time() - t_phase}
        a_core.rank_stats(reset=True)
        from production_stack_tpu_torch.ops.paged_attention import (
            paged_attention,
        )
        from production_stack_tpu_torch.ops.prefill_attention import (
            cached_prefill_attention,
        )

        wrappers = (paged_attention, cached_prefill_attention)
        for fn in wrappers:  # this process's counts: the leader's and b's
            fn.launches_by_shape.clear()
        t_part = time.time()
        _kvr_tp2_drive(a_core, b[1], summary)
        parts["tp2_drive"] = time.time() - t_part
        ranks = a_core.rank_stats()
        _check_ranks("kv_ranks Llama-3-8B tp 2", ranks, 2,
                     {fn.__name__: tp_shape_key(16, 4, 128)
                      for fn in wrappers})
        for r in ranks:
            for fn, by in r["launches_by_shape"].items():
                key = tp_shape_key(16, 4, 128)
                launches[(fn, key)] = launches.get((fn, key), 0) + by.get(
                    key, 0)
        summary["ranks"] = _rank_summary(ranks)
        _stop(a_httpd, a_core)
        a = None
        # The pipe.
        deadline = time.monotonic() + 300
        peer_url = f"http://127.0.0.1:{port}"
        while True:
            try:
                Client(port).get("/health")
                break
            except OSError:
                if peer.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError("kv_ranks: the peer server did not "
                                         "come up")
                time.sleep(0.5)
        summary["pipe_probe_s"] = pipe_probe()["seconds"]
        t_part = time.time()
        _kvr_pipe_drive(b[0], b[1], peer_url, summary)
        parts["pipe_drive"] = time.time() - t_part
        key = tp_shape_key(32, 8, 128)
        for fn in wrappers:
            launches[(fn.__name__, key)] = fn.launches_by_shape.get(key, 0)
            if launches[(fn.__name__, key)] <= 0:
                raise AssertionError(f"kv_ranks: the tp 1 engine launched no "
                                     f"{fn.__name__}")
        _stop(b[0], b[1])
        b = None
    finally:
        for srv in (a, b):
            if srv is not None:
                _stop(srv[0], srv[1])
        if peer.poll() is None:
            peer.terminate()
            try:
                peer.wait(timeout=30)
            except subprocess.TimeoutExpired:
                peer.kill()
                peer.wait()
        err.close()
    t_part = time.time()
    _kvr_f32_extracts(summary)
    parts["f32_extracts"] = time.time() - t_part
    summary["phase_s"] = time.time() - t_phase
    summary["part_s"] = parts
    log(f"[kv_ranks] {json.dumps(summary)}")
    return launches, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="only profile the decode step (no result line)")
    ap.add_argument("--tp-cards", action="store_true",
                    help="only tensor and pipeline parallelism with a card "
                         "a rank, on a host of 2 or more cards (no result "
                         "line)")
    ap.add_argument("--pp-cards", action="store_true",
                    help="only pipeline parallelism with a card a stage, on "
                         "a host of 2 or more cards (no result line)")
    ap.add_argument("--pp-70b", action="store_true",
                    help="only Llama-3-70B's shapes at pp 4, a card a stage, "
                         "on a host of 4 cards (no result line)")
    ap.add_argument("--kv-ranks", action="store_true",
                    help="only the kv_ranks phase: KV movement and the "
                         "lifecycle across ranks, the KV device pipe (no "
                         "result line)")
    args = ap.parse_args(argv)
    # A crash in native code (a segfault) prints every thread's Python
    # stack to standard error before the process dies.
    faulthandler.enable()

    os.environ.setdefault("TPU_STACK_LOG_LEVEL", "WARNING")
    if args.tp_cards or args.pp_cards or args.pp_70b:
        # Before the first allocation, in this process and the ranks it
        # starts: Llama-3-70B's init draws a 37.6 GB leaf beside ~25 GB of
        # kept slices, which a fragmented cache cannot place.
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; nothing was run")
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "production_stack_tpu_torch")):
        log("chip_smoke: run it from a checkout of the repo "
            "(production_stack_tpu_torch/ not found beside it)")
        return 2
    sys.path.insert(0, here)
    from production_stack_tpu_torch.ops import _build

    if not (args.profile or args.tp_cards or args.pp_cards or args.pp_70b):
        start_pipe_probe()

    smi = nvidia_smi_line()
    print(f"device: {smi}", flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    if args.profile:
        for extra in ((), INT8_ARGS):
            report = profile_phase(extra)
            print(json.dumps({"profile": report}), flush=True)
            _free_device_memory()
        report = profile_structured_phase()
        print(json.dumps({"profile_structured": report}), flush=True)
        _free_device_memory()
        print(f"card: {smi}", flush=True)
        return 0
    if args.kv_ranks:
        _build.build(["paged_attention", "prefill_attention"])
        _, summary = kv_ranks_phase(here, smi)
        print(json.dumps({"kv_ranks": summary}), flush=True)
        print(f"card: {smi}", flush=True)
        return 0
    if args.tp_cards or args.pp_cards or args.pp_70b:
        _build.build(["paged_attention", "prefill_attention"])
        if args.tp_cards:
            print(json.dumps({"tp_cards": tp_cards_phase(here, smi)}),
                  flush=True)
        phase = pp_70b_phase(smi) if args.pp_70b else pp_cards_phase(here,
                                                                     smi)
        print(json.dumps({"pp_cards": phase}), flush=True)
        print(f"card: {smi}", flush=True)
        return 0
    t0 = time.time()
    paths = _build.build(["paged_attention", "prefill_attention",
                          "page_probes"], verbose=True)
    build_s = time.time() - t0
    for name, text in _build.build.last_log.items():
        log(f"[build] {name}:\n{text}")
    log(f"[build] all three kernel libraries built in {build_s:.1f} s")
    print(json.dumps({"sass": sass_counts(paths)}), flush=True)

    got = threefry_check("cuda")
    if got != GOLDEN:
        raise AssertionError(f"threefry on the card differs from JAX's "
                             f"golden values: {got}")
    print(json.dumps({"threefry": {"card": smi, "keys": len(got["keys"]),
                                   "bits": sum(map(len, got["bits"])),
                                   "draws": got["draws"],
                                   "bit_equal": True}}), flush=True)

    results = kernel_phase()
    tp_results = tp_kernel_phase()
    log(f"[time] {time.time() - t0:.0f} s through the kernel phase")
    probe_results, probes = probe_phase()
    print(json.dumps({"probes": probes}), flush=True)
    log(f"[time] {time.time() - t0:.0f} s through the probe phase")
    launches = {}
    for label, extra, entries in (
            ("bf16", (), ("paged_attention", "cached_prefill_attention")),
            ("int8 KV + int8 weights", INT8_ARGS,
             ("paged_attention_int8", "cached_prefill_attention_int8"))):
        # The previous engine's pool and weights go before the next one
        # sizes its pool from free memory.
        _free_device_memory()
        counts, summary = serve_phase(label, extra, entries)
        launches.update(counts)
        summary["card"] = smi
        log(f"[serve] {json.dumps(summary)}")
        print(json.dumps({"serve": summary}), flush=True)
        print(json.dumps({"recorder": dict(summary["recorder"], card=smi,
                                           config=label)}), flush=True)
        print(f"[serve] {label}: {summary['prefill_groups']} storm groups, "
              f"{summary['batched_prefill_dispatches']} batched prefill "
              f"dispatches, cached-prefill kernel launches "
              f"{counts[entries[1]]}; step kinds "
              f"{summary['recorder']['kinds']}; bandwidth share "
              f"{summary['recorder']['bandwidth_utilization']} of 3.35e12 "
              f"B/s ({smi})", flush=True)
    _free_device_memory()
    entries = ("paged_attention", "cached_prefill_attention")
    counts, summary, chunked = chunked_phase(entries)
    for name, n in counts.items():
        launches[name] += n
    summary["card"] = smi
    log(f"[serve] {json.dumps(summary)}")
    print(json.dumps({"chunked": summary}), flush=True)
    _free_device_memory()
    counts, summary = fused_phase(entries, chunked)
    for name, n in counts.items():
        launches[name] += n
    summary["card"] = smi
    print(json.dumps({"fused": summary}), flush=True)
    log(f"[time] {time.time() - t0:.0f} s through the fused phase")
    _free_device_memory()
    print(json.dumps({"asr": asr_phase(smi, here)}), flush=True)
    log(f"[time] {time.time() - t0:.0f} s through the asr phase")
    for label, extra, entries, surface in (
            ("bf16", (), ("paged_attention", "cached_prefill_attention"),
             True),
            ("int8 KV + int8 weights", INT8_ARGS,
             ("paged_attention_int8", "cached_prefill_attention_int8"),
             False)):
        _free_device_memory()
        counts, summary = structured_phase(
            f"{label}, {STRUCTURED_LAYERS} layers", extra, entries, surface,
            llama_8b_dir(here, STRUCTURED_LAYERS))
        for name, n in counts.items():
            launches[name] += n
        summary["card"] = smi
        log(f"[structured] {json.dumps(summary)}")
        print(json.dumps({"structured": summary}), flush=True)
        log(f"[time] {time.time() - t0:.0f} s through the structured "
            f"{label} phase")
    log(f"[time] {time.time() - t0:.0f} s before the spec phases")
    spec_counts, drafter_counts = spec_phase(smi, here)
    for name, n in spec_counts.items():
        launches[name] += n
    # The verify row counts the cached-prefill kernel's launches on the
    # speculative runs (their verify, catch-up and prompt chunks); the
    # draft-step row those of the self-drafting run, whose grammar rows
    # take the FSM-constrained draft steps.
    launches["cached_prefill_attention_verify"] = spec_counts[
        "cached_prefill_attention"]
    launches["cached_prefill_attention_draft_step"] = drafter_counts[
        "cached_prefill_attention"]
    spec_parity_phase(smi)
    log(f"[time] {time.time() - t0:.0f} s through the spec phases")
    for label, extra, entries in (
            ("bf16", (), ("paged_attention", "cached_prefill_attention")),
            ("int8 KV + int8 weights", INT8_ARGS,
             ("paged_attention_int8", "cached_prefill_attention_int8"))):
        _free_device_memory()
        counts, summary = kv_phase(label, extra, entries, smi, here)
        for name, n in counts.items():
            launches[name] += n
        print(json.dumps({"kv": summary}), flush=True)
        log(f"[time] {time.time() - t0:.0f} s through the kv {label} phase")
    for label, extra in (("OPT-125m bf16", ()),
                         ("OPT-125m int8 KV", ("--kv-cache-dtype", "int8"))):
        _free_device_memory()
        counts, summary = opt_phase(label, extra, smi)
        launches.update(counts)
        print(json.dumps({"opt": summary}), flush=True)
        log(f"[time] {time.time() - t0:.0f} s through the {label} phase")
    for key, phase in (("mixtral", lambda: mixtral_phase(here, smi)),
                       ("lifecycle", lambda: lifecycle_phase(smi))):
        _free_device_memory()
        counts, summary = phase()
        for name, n in counts.items():
            launches[name] += n
        print(json.dumps({key: summary}), flush=True)
        log(f"[time] {time.time() - t0:.0f} s through the {key} phase")
    _free_device_memory()
    counts, summary = checkpoint_phase(here, smi)
    for name, n in counts.items():
        launches[name] += n
    print(json.dumps({"checkpoint": summary}), flush=True)
    log(f"[time] {time.time() - t0:.0f} s through the checkpoint phase")
    _free_device_memory()
    arch_parity_phase(smi)
    log(f"[time] {time.time() - t0:.0f} s through the arch parity phase")
    tp_launches, tp_summary, tp1_streams = tp_phase(here, smi)
    print(json.dumps({"tp": tp_summary}), flush=True)
    log(f"[time] {time.time() - t0:.0f} s through the tp phase")
    pp_launches, pp_summary = pp_phase(here, smi, tp1_streams)
    print(json.dumps({"pp": pp_summary}), flush=True)
    log(f"[time] {time.time() - t0:.0f} s through the pp phase")
    kv_launches, kv_summary = kv_ranks_phase(here, smi)
    print(json.dumps({"kv_ranks": kv_summary}), flush=True)
    log(f"[time] {time.time() - t0:.0f} s through the kv_ranks phase")
    # Llama-3-8B's stages, and the kv_ranks phase's tp 1 engine, launch
    # both kernels at the full 32/8 heads in bf16: the main rows' shape.
    for name in ("paged_attention", "cached_prefill_attention"):
        for by in (pp_launches, kv_launches):
            launches[name] += by.get((name, tp_shape_key(32, 8, 128)), 0)
    for name, r in tp_results.items():
        fn = ("paged_attention" if name.startswith("paged_attention")
              else "cached_prefill_attention")
        launches[name] = (tp_launches.get((fn, r["shape"]), 0)
                          + kv_launches.get((fn, r["shape"]), 0))
    results.update(tp_results)
    results.update(probe_results)
    replaces = {
        "paged_attention":
            "production_stack_tpu/ops/pallas_paged_attention.py:231",
        "cached_prefill_attention":
            "production_stack_tpu/ops/pallas_prefill_attention.py:221",
        "kernel_dma_only": "benchmarks/kernel_dma_only.py:81",
        "kernel_probe_strided": "benchmarks/kernel_probe_strided.py:117"}
    sources = {
        "paged_attention":
            "production_stack_tpu_torch/csrc/paged_attention.cu",
        "cached_prefill_attention":
            "production_stack_tpu_torch/csrc/prefill_attention.cu",
        "kernel_dma_only": "production_stack_tpu_torch/csrc/page_probes.cu",
        "kernel_probe_strided":
            "production_stack_tpu_torch/csrc/page_probes.cu"}
    launches.update({name: r["launches"]
                     for name, r in probe_results.items()})
    kernels = []
    for name, r in results.items():
        base = next(b for b in replaces if name.startswith(b))
        kernels.append(dict(
            name=name, route="cuda", source=sources[base],
            replaces=replaces[base], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
