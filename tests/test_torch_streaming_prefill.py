"""Row 12 of the PyTorch port (the streaming prefill kernel's plain version)
and the length dispatch of `ops.attention.prefill_attention`, against the
JAX package: its Pallas streaming kernel in interpret mode, its XLA path,
and a tiny f32 model whose prompts take the streaming kernel in both
packages.

f32, and bf16 against the streaming kernel. Tolerances: rtol/atol 2e-3
against the streaming kernel in f32 (the JAX package's own test of it holds
it to the XLA path there: blocked online softmax against one softmax over
all columns); in bf16 one rounding of the output (2**-7 of the largest) and
at most 1% of the outputs different (see BF16_DIFFER); 1e-5 against the XLA
path (summation order only); model logits within 1e-4 of the largest.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from trtllm_llama_tpu.config import ModelConfig as JaxConfig
from trtllm_llama_tpu.models import llama as jax_llama
from trtllm_llama_tpu.ops import attention as jax_attn
from trtllm_llama_tpu.ops.pallas.attention import (
    streaming_prefill_attention_kernel as jax_streaming,
)
from trtllm_llama_tpu.ops.registry import KERNELS as JAX_KERNELS
from trtllm_llama_tpu.ops.registry import enable_pallas_kernels
from trtllm_llama_tpu_torch.config import ModelConfig
from trtllm_llama_tpu_torch.convert.bridge import params_from_numpy
from trtllm_llama_tpu_torch.models import llama
from trtllm_llama_tpu_torch.ops import attention
from trtllm_llama_tpu_torch.ops.kernels import prefill_attention as _prefill
from trtllm_llama_tpu_torch.ops.kernels import (
    streaming_prefill_attention as _streaming,
)
from trtllm_llama_tpu_torch.ops.registry import KERNELS

torch.set_num_threads(1)

STREAM_TOL = dict(rtol=2e-3, atol=2e-3)
XLA_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _qkv(b, s, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32) * 0.3
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32) * 0.3
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    return q, k, v


# the shapes of the JAX package's own streaming test
@pytest.mark.parametrize("hq,hkv,s,lens", [
    (4, 2, 640, (600, 512)),        # several 512-row query blocks, GQA
    (2, 2, 1536, (1536, 700)),      # causal skip over several KV blocks
    (2, 1, 2100, (2100, 64)),       # S not a multiple of any block
])
def test_streaming_plain_matches_jax_kernel(hq, hkv, s, lens):
    q, k, v = _qkv(2, s, hq, hkv, 128, seed=7)
    sl = np.asarray(lens, np.int32)
    want = np.asarray(jax_streaming(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(sl),
                                    interpret=True))
    got = _streaming.streaming_prefill_attention_kernel(
        _t(q), _t(k), _t(v), _t(sl)).numpy()
    np.testing.assert_allclose(got, want, **STREAM_TOL)
    want_xla = jax_attn.prefill_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), jnp.asarray(sl))
    np.testing.assert_allclose(got, np.asarray(want_xla), **XLA_TOL)


# P at f32 precision: the Pallas kernel keeps p in f32 into its f32 P V, as
# the port's plain version does (and the card's tile, through P's terms);
# the XLA path rounds p to the inputs' dtype first. The two f32 paths sum in
# other orders, which flips the bf16 rounding of an output only near a tie:
# 0.02% of the outputs at these shapes, each by one rounding; P rounded to
# bf16 changes 39% of them.
BF16_TOL = 2.0 ** -7      # one bf16 rounding of the output, relative
BF16_DIFFER = 0.01        # the share of outputs that may differ at all


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("hq,hkv,s,lens", [
    (4, 2, 640, (600, 512)),
    (2, 1, 2100, (2100, 64)),
])
def test_streaming_plain_bf16_matches_jax_kernel(hq, hkv, s, lens, alibi):
    """bf16 q/k/v: the port's plain version against the Pallas streaming
    kernel (interpret mode): outputs within one bf16 rounding, and at most
    1% of them different at all. Both keep the probabilities in f32 through
    P V, the contract the card's row 12 meets."""
    q, k, v = (jnp.asarray(x, jnp.bfloat16) for x in _qkv(2, s, hq, hkv, 128,
                                                         seed=11))
    sl = np.asarray(lens, np.int32)
    slopes = attention.alibi_slopes(hq) if alibi else None
    want = np.asarray(jax_streaming(
        q, k, v, jnp.asarray(sl), interpret=True,
        alibi=None if slopes is None else jnp.asarray(slopes.numpy())
    ).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16) for x in (q, k, v))
    kw = {} if slopes is None else {"alibi": slopes}
    got = _streaming.streaming_prefill_attention_kernel(
        tq, tk, tv, _t(sl), **kw)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    assert diff.max() <= BF16_TOL * np.abs(want).max(), diff.max()
    assert (diff > 0).mean() <= BF16_DIFFER, (diff > 0).mean()


def test_streaming_plain_length_zero_averages_like_xla():
    """A length of 0 masks every column: the XLA path's softmax is then
    uniform over all S columns, and so is the port's. (The Pallas streaming
    kernel skips every block of such a row and returns 0.)"""
    q, k, v = _qkv(2, 96, 4, 2, 32, seed=8)
    sl = np.asarray([0, 96], np.int32)
    got = _streaming.streaming_prefill_attention_kernel(
        _t(q), _t(k), _t(v), _t(sl)).numpy()
    want = jax_attn.prefill_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(sl))
    np.testing.assert_allclose(got, np.asarray(want), **XLA_TOL)
    mean_v = np.repeat(v[0].mean(0), 2, axis=0)            # [Hq, D]
    np.testing.assert_allclose(got[0], np.broadcast_to(mean_v, got[0].shape),
                               rtol=1e-5, atol=1e-5)


def test_streaming_plain_equals_kernel2_plain():
    q, k, v = _qkv(3, 200, 8, 2, 64, seed=9)
    sl = _t(np.asarray([200, 77, 1], np.int32))
    got = _streaming.streaming_prefill_attention_kernel_plain(
        _t(q), _t(k), _t(v), sl, sm_scale=0.1)
    want = _prefill.prefill_attention_kernel_plain(_t(q), _t(k), _t(v), sl,
                                                   sm_scale=0.1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **XLA_TOL)


def _recording(monkeypatch):
    calls = []

    def record(name):
        def fn(q, k, v, seq_lens=None, sm_scale=None):
            calls.append((name, q.shape[1]))
            return torch.zeros_like(q)
        return fn
    monkeypatch.setattr(_streaming, "streaming_prefill_attention_kernel",
                        record("streaming"))
    monkeypatch.setattr(_prefill, "prefill_attention_kernel", record("kernel2"))
    return calls


@pytest.mark.parametrize("min_s,s,want", [
    (2048, 2048, "kernel2"), (2048, 2049, "streaming"),
    (None, 2048, "kernel2"), (None, 2049, "streaming"),
    (0, 1, "streaming"), (64, 64, "kernel2"), (64, 65, "streaming"),
])
def test_prefill_dispatch_by_length(monkeypatch, min_s, s, want):
    calls = _recording(monkeypatch)
    monkeypatch.setitem(KERNELS, "prefill_streaming_min_s", min_s)
    x = torch.zeros((1, s, 2, 32))
    attention.prefill_attention(x, x, x)
    assert calls == [(want, s)]


def test_streaming_rejects_alibi():
    """ALiBi is ported: the streaming plain version takes slopes, and gives
    kernel 2's plain version's output with the same slopes; slopes of the
    wrong length are refused."""
    q, k, v = _qkv(2, 70, 4, 2, 32, seed=10)
    sl, slopes = _t(np.asarray([70, 33], np.int32)), attention.alibi_slopes(4)
    got = _streaming.streaming_prefill_attention_kernel(_t(q), _t(k), _t(v),
                                                        sl, alibi=slopes)
    want = _prefill.prefill_attention_kernel_plain(_t(q), _t(k), _t(v), sl,
                                                   alibi=slopes)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **XLA_TOL)
    with pytest.raises(RuntimeError):
        _streaming.streaming_prefill_attention_kernel(_t(q), _t(k), _t(v),
                                                      alibi=torch.ones(3))


def test_tiny_model_long_prompt_uses_streaming_prefill(monkeypatch):
    """A tiny f32 model (head_dim 128) with prefill_streaming_min_s = 64 in
    both packages: a 100-token prompt goes through the streaming kernel in
    each (the JAX package's under its interpret mode), and the logits agree
    within 1e-4 of the largest."""
    kw = dict(hidden_size=256, num_heads=2, num_kv_heads=2, head_dim=128,
              dtype="float32", max_position_embeddings=256)
    jcfg, cfg = JaxConfig.tiny(**kw), ModelConfig.tiny(**kw)
    jparams = jax_llama.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    ids = np.random.default_rng(3).integers(3, 250, (2, 100)).astype(np.int32)
    lens = np.asarray([100, 70], np.int32)

    enable_pallas_kernels(True)
    old = dict(JAX_KERNELS)
    JAX_KERNELS["prefill_streaming_min_s"] = 64
    JAX_KERNELS["fused_decode_attention"] = None
    try:
        with pltpu.force_tpu_interpret_mode():
            want, _ = jax_llama.forward_prefill(
                jparams, jcfg, jnp.asarray(ids), jnp.asarray(lens),
                jax_llama.init_caches(jcfg, 2, 128))
            want = np.asarray(want)
    finally:
        JAX_KERNELS.update(old)
        enable_pallas_kernels(False)

    calls = []
    plain = _streaming.streaming_prefill_attention_kernel

    def record(q, *args, **kwargs):
        calls.append(q.shape[1])
        return plain(q, *args, **kwargs)
    monkeypatch.setattr(_streaming, "streaming_prefill_attention_kernel",
                        record)
    monkeypatch.setitem(KERNELS, "prefill_streaming_min_s", 64)
    with torch.inference_mode():
        got, _ = llama.forward_prefill(
            params, cfg, _t(ids), _t(lens),
            llama.init_caches(cfg, 2, 128, "cpu"))
    assert calls == [100] * cfg.num_layers
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-4, err
