#!/usr/bin/env python3
"""How precisely rows 10, 12 and 13 must carry P through P V: path 7's 7B
prefill logits with the attention's P in 1, 2 and 3 bf16 terms, on one GPU.

    python3 attention_precision.py [--layers N]

Builds path 7 as chip_smoke.py does (the offline build of LLaMA-7B at full
depth: static per-tensor SmoothQuant W8A8 + int8 KV from an engine dir,
random weights, seed 0), then prefills its bs1 and bs4 prompts (8 and
8 / 5 / 12 / 3 tokens) with every projection and the attention on their
plain versions: the reference. Against it, the same prefill with the
attention's probabilities P carried through P V as the sum of 1, 2 and 3
bf16 terms (the plain version's p_terms; 1 is P rounded to bf16, as row
12's mma.sync loop before its redesign and the JAX package's XLA path
round it), with the card's tile (row 10, three terms) under the plain
projections and under the kernels, and with row 12 (every prompt sent to
it: `prefill_streaming_min_s` 0) under both. Prints
each variant's largest logit error relative to the largest logit, beside
LOGITS_TOL, and the card's name and power limit. A variant past the
tolerance is reported, not an error: this measures how far the network
amplifies the rounding of P. Exits 1 without a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import subprocess
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=32)
    args = ap.parse_args(argv)
    from unittest import mock

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("attention_precision: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import chip_smoke as cs
    from trtllm_llama_tpu_torch.models import llama
    from trtllm_llama_tpu_torch.ops.kernels import prefill_attention as pa
    from trtllm_llama_tpu_torch.ops.kernels import w8a8_matmul as w8a8
    from trtllm_llama_tpu_torch.ops.registry import KERNELS

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False

    def measure(sess):
        cfg = sess.cfg
        rng = np.random.default_rng(0)        # drive_path's prompts
        p1 = rng.integers(3, cfg.vocab_size, (1, 8))
        rng.integers(3, cfg.vocab_size, (1, 8))
        p4 = [rng.integers(3, cfg.vocab_size, n).tolist()
              for n in (8, 5, 12, 3)]
        for what, prompts in (("bs1", [p1[0].tolist()]), ("bs4", p4)):
            b = len(prompts)
            ids = torch.zeros((b, 16), dtype=torch.int32, device="cuda")
            for row, prompt in enumerate(prompts):
                ids[row, :len(prompt)] = torch.as_tensor(prompt,
                                                         device="cuda")
            lens = torch.tensor([len(p) for p in prompts],
                                dtype=torch.int32, device="cuda")

            def prefill(plain_projections, attention):
                """attention: row 10's stand-in, or None for row 12."""
                with contextlib.ExitStack() as stack, \
                        torch.inference_mode():
                    if plain_projections:
                        stack.enter_context(cs.patched(
                            w8a8, "w8a8_matmul", w8a8.w8a8_matmul_plain))
                    if attention is None:
                        stack.enter_context(mock.patch.dict(
                            KERNELS, prefill_streaming_min_s=0))
                    else:
                        stack.enter_context(cs.patched(
                            pa, "prefill_attention_kernel", attention))
                    caches = llama.init_caches(cfg, b, 66, "cuda",
                                               sess.kv_scales)
                    return llama.forward_prefill(sess.params, cfg, ids, lens,
                                                 caches, rope=sess.rope)[0]
            plain = pa.prefill_attention_kernel_plain
            ref = prefill(True, plain)
            tile = pa.prefill_attention_kernel
            for name, plain_proj, attention in (
                    ("P in 1 bf16 term (rounded)", True,
                     functools.partial(plain, p_terms=1)),
                    ("P in 2 bf16 terms", True,
                     functools.partial(plain, p_terms=2)),
                    ("P in 3 bf16 terms", True,
                     functools.partial(plain, p_terms=3)),
                    ("row 10's tile, plain projections", True, tile),
                    ("row 10's tile and row 5's kernels", False, tile),
                    ("row 12, plain projections", True, None),
                    ("row 12 and row 5's kernels", False, None)):
                cs.compare(f"{what} {name}", prefill(plain_proj, attention),
                           ref, [], tol=cs.LOGITS_TOL)

    errors = []
    measure(cs.build_offline(argparse.Namespace(layers=args.layers), errors,
                             {"_e2e": {}}))
    if errors:
        print("attention_precision FAILED:\n  " + "\n  ".join(errors),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
