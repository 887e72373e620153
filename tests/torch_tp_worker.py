"""The ranks of `tests/test_torch_tp.py`: tensor parallelism of the port over
gloo on the CPU, started by `trtllm_llama_tpu_torch/parallel/launch.py`.

This module imports torch and the port only (never JAX: the test runs
its ranks with JAX made unimportable). `run(rank, world, data_dir)` reads
the params the test wrote (`params_<case>.pt`, `cases.json`), runs every
scenario in one launch and writes its results to `rank<r>.npz`:

- `overlap_<kind>_<chunks>`: a row-parallel `dense` (woq int8, fp8, SQ
  per-token) at 96 rows, K = 256, N = 512, under overlap_chunks 4 and 0,
  with the windows each launch was given (`windows_<kind>_<chunks>`);
- `sq_scale`, `sq_codes`: the per-token scales and this rank's codes that
  the SQ row path quantized with;
- `tokens_<case>`, `logits_<case>`: a tp GenerationSession's greedy tokens
  and its prefill logits, for int8, int4 g32, fp8 and SQ per-token;
- `serve_<dense|paged>`: a tp ServingEngine's tokens for three requests.
"""

import json
import os

import numpy as np
import torch

from trtllm_llama_tpu_torch.config import EngineConfig, ModelConfig
from trtllm_llama_tpu_torch.models import llama
from trtllm_llama_tpu_torch.ops import linear
from trtllm_llama_tpu_torch.ops.kernels import fp8_matmul as f8k
from trtllm_llama_tpu_torch.ops.kernels import w8a8_matmul as w8a8
from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq
from trtllm_llama_tpu_torch.ops.registry import KERNELS
from trtllm_llama_tpu_torch.parallel import Mapping
from trtllm_llama_tpu_torch.parallel.sharding import shard_params
from trtllm_llama_tpu_torch.quantization.mode import QuantMode
from trtllm_llama_tpu_torch.quantization.tensors import (
    quantize_fp8_weight, quantize_smoothquant_weight, quantize_weight_only)
from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
from trtllm_llama_tpu_torch.runtime.serving import ServingEngine
from trtllm_llama_tpu_torch.runtime.session import GenerationSession

# the row-parallel scenario: full shapes (each rank holds K / world)
OVERLAP_L, OVERLAP_K, OVERLAP_N, OVERLAP_M, OVERLAP_LAYER = 2, 256, 512, 96, 1
SESSION_ECFG = dict(max_batch_size=2, max_input_len=32, max_seq_len=64)
SERVE_ECFG = dict(max_batch_size=3, max_input_len=16, max_seq_len=32)


def overlap_inputs():
    """x [M, K] and the full float weight [L, K, N] of the row scenario."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((OVERLAP_M, OVERLAP_K)).astype(np.float32)
    w = (rng.standard_normal((OVERLAP_L, OVERLAP_K, OVERLAP_N)) * 0.05
         ).astype(np.float32)
    return x, w


def overlap_weight(kind, w):
    """The full container of the row scenario for `kind`."""
    w = torch.from_numpy(w)
    if kind == "woq":
        return quantize_weight_only(w, 8, 0)
    if kind == "fp8":
        return quantize_fp8_weight(w)
    return quantize_smoothquant_weight(w, torch.full((OVERLAP_L,), 3.0))


def session_ids():
    return np.random.default_rng(0).integers(3, 250, (2, 10))


def serve_prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(3, 250, (n,)).tolist() for n in (5, 9, 12)]


def _spy(module, name, log):
    """Wrap module.name to log each call's n_window; returns the original."""
    orig = getattr(module, name)

    def spy(*args, **kwargs):
        log.append(kwargs.get("n_window"))
        return orig(*args, **kwargs)
    setattr(module, name, spy)
    return orig


def _overlap(rank, world, group, out):
    x, w = overlap_inputs()
    k = OVERLAP_K // world
    xs = torch.from_numpy(x[:, rank * k:(rank + 1) * k].copy())
    sq_seen = []
    orig_pre = linear.dense_prequant

    def pre_spy(x_q, s_x, *args, **kwargs):
        sq_seen.append((x_q.clone(), s_x.clone()))
        return orig_pre(x_q, s_x, *args, **kwargs)
    for kind, (mod, fn) in (("woq", (woq, "woq_matmul_stacked")),
                            ("fp8", (f8k, "fp8_matmul_stacked")),
                            ("sq", (w8a8, "w8a8_matmul_stacked"))):
        full = {"layers": {"wo": overlap_weight(kind, w)}}
        ws = shard_params(full, Mapping(tp=world), rank)["layers"]["wo"]
        for chunks in (4, 0):
            log = []
            orig = _spy(mod, fn, log)
            linear.dense_prequant = pre_spy
            KERNELS["overlap_chunks"] = chunks
            try:
                with linear.tp_scope(group):
                    y = linear.dense(xs, ws, torch.float32, OVERLAP_LAYER,
                                     part="row")
            finally:
                setattr(mod, fn, orig)
                linear.dense_prequant = orig_pre
                KERNELS["overlap_chunks"] = 4
            out[f"overlap_{kind}_{chunks}"] = y.numpy()
            out[f"windows_{kind}_{chunks}"] = np.array(
                [wi if wi is not None else (-1, -1) for wi in log])
    x_q, s_x = sq_seen[0]
    out["sq_scale"] = s_x.numpy()
    out["sq_codes"] = x_q.numpy()


def _port_cfg(meta):
    return ModelConfig.tiny(dtype="float32",
                            quant_mode=QuantMode(meta["quant_mode"]),
                            group_size=meta["group_size"])


def run(rank, world, data_dir):
    torch.set_num_threads(1)
    mapping = Mapping(tp=world)
    group, rank = mapping.make_group(backend="gloo", device="cpu")
    out = {}
    _overlap(rank, world, group, out)
    with open(os.path.join(data_dir, "cases.json")) as f:
        cases = json.load(f)
    scfg = SamplingConfig(end_id=-1)
    ids = session_ids()
    for case, meta in cases.items():
        params = torch.load(os.path.join(data_dir, f"params_{case}.pt"),
                            weights_only=False)
        cfg = _port_cfg(meta)
        if case == "f32":       # serving, dense and paged
            for paged in (False, True):
                eng = ServingEngine(cfg, params, EngineConfig(**SERVE_ECFG),
                                    sampling=scfg, decode_chunk=3,
                                    device="cpu", paged=paged, block_size=8,
                                    mapping=mapping, group=group)
                rids = [eng.submit(p, 5) for p in serve_prompts()]
                done = eng.run_to_completion()
                out["serve_" + ("paged" if paged else "dense")] = np.array(
                    [done[r].output_ids for r in rids])
            continue
        sess = GenerationSession(cfg, params, EngineConfig(**SESSION_ECFG),
                                 device="cpu", mapping=mapping, group=group)
        gen = sess.generate(ids, max_new_tokens=8, sampling=scfg)
        out[f"tokens_{case}"] = gen.output_ids
        with torch.inference_mode(), linear.tp_scope(sess.group):
            caches = llama.init_caches(sess.model_cfg, ids.shape[0], 64,
                                       "cpu")
            logits, _ = llama.forward_prefill(
                sess.params, sess.model_cfg, torch.from_numpy(ids),
                torch.full((ids.shape[0],), ids.shape[1], dtype=torch.int32),
                caches)
        out[f"logits_{case}"] = logits.numpy()
        assert isinstance(sess.params["layers"]["wq"], type(
            params["layers"]["wq"])) and "wqkv" not in sess.params["layers"]
    np.savez(os.path.join(data_dir, f"rank{rank}.npz"), **out)


def fail_one(rank, world):
    """Rank 1 dies at once; rank 0 waits in a collective that cannot
    complete (the launcher must kill it, not wait out its timeout)."""
    group, rank = Mapping(tp=world).make_group(backend="gloo", device="cpu")
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    torch.distributed.all_reduce(torch.ones(1), group=group)
    torch.distributed.all_reduce(torch.ones(1), group=group)


def cuda_rank(rank, world, out_dir):
    """The card test's rank (tests/test_torch_cuda_tp.py): gloo's CUDA
    all-reduce, then a tiny bf16 int8 model at tp = world on the card:
    its greedy tokens, its prefill logits and the single device's."""
    from trtllm_llama_tpu_torch.parallel import comm
    from trtllm_llama_tpu_torch.quantization.quantize import (
        init_random_quantized_params)
    torch.cuda.set_device(0)
    mapping = Mapping(tp=world)
    group, rank = mapping.make_group(backend="gloo", device="cuda")
    x, work = comm.all_reduce_sum(torch.full((3,), rank + 1.0,
                                             device="cuda"), group,
                                  async_op=True)
    work.wait()
    mx = comm.all_reduce_max(torch.full((3,), float(rank), device="cuda"),
                             group)
    gloo_ok = (x.tolist() == [world * (world + 1) / 2] * 3
               and mx.tolist() == [world - 1.0] * 3)
    cfg = ModelConfig.tiny(dtype="bfloat16", num_layers=2,
                           quant_mode=QuantMode.use_weight_only())
    params = init_random_quantized_params(cfg, seed=0, device="cuda")
    ecfg = EngineConfig(max_batch_size=2, max_input_len=32, max_seq_len=64)
    ids = session_ids()
    lens = torch.full((ids.shape[0],), ids.shape[1], dtype=torch.int32,
                      device="cuda")
    logits = {}
    for name, kw in (("ref", {}), ("tp", dict(mapping=mapping,
                                              group=group))):
        sess = GenerationSession(cfg, params, ecfg, device="cuda", **kw)
        with torch.inference_mode(), linear.tp_scope(sess.group):
            caches = llama.init_caches(sess.model_cfg, ids.shape[0], 64,
                                       "cuda")
            logits[name] = llama.forward_prefill(
                sess.params, sess.model_cfg,
                torch.as_tensor(ids, device="cuda"), lens, caches,
                rope=sess.rope)[0].float().cpu().numpy()
    tokens = sess.generate(ids, max_new_tokens=8,
                           sampling=SamplingConfig(end_id=-1)).output_ids
    np.savez(os.path.join(out_dir, f"cuda_rank{rank}.npz"), gloo_ok=gloo_ok,
             tokens=tokens, logits=logits["tp"], ref_logits=logits["ref"])
