"""Bidirectional (non-causal) prefill attention in the PyTorch port against
the JAX package: `ops.attention.prefill_attention(causal=False)` on
either side of `prefill_streaming_min_s` (row 10's and row 12's plain
versions), and both plain versions called directly, against the JAX
package's `prefill_attention(causal=False)`, which runs every non-causal
call on XLA. The mask is the length mask alone; every query row is
compared, pad rows included, and a length of 0 averages V over all S.

Inputs are seeded numpy arrays handed to both packages. Tolerances: f32
within 1e-6 of the largest |out| (the order of the f32 sums only); bf16
within 3% of the largest (the JAX path rounds P to bf16 before P V, the
port's plain versions keep it in f32). The CUDA entries' signatures are
read from csrc/ and held against the wrappers' ctypes lists, the causal
flag at its place: no compiler runs here.
"""

import re
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from trtllm_llama_tpu.ops import attention as jax_attn
from trtllm_llama_tpu_torch.ops import attention
from trtllm_llama_tpu_torch.ops.kernels import prefill_attention as _prefill
from trtllm_llama_tpu_torch.ops.kernels import (
    streaming_prefill_attention as _streaming,
)
from trtllm_llama_tpu_torch.ops.registry import KERNELS

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
F32_REL = 1e-6
BF16_REL = 3e-2

CASES = [  # (B, S, Hq, Hkv, D, lens)
    (2, 48, 4, 4, 32, (48, 48)),         # full length
    (3, 100, 8, 2, 64, (100, 37, 0)),    # GQA 4, ragged, a length of 0
    (2, 70, 4, 1, 32, (1, 70)),          # GQA 4 (one KV head), S off 64
    (1, 130, 2, 2, 128, (0,)),           # only a length of 0
]


def _qkv(b, s, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32) * 0.5
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32) * 0.5
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    return q, k, v


def _jax(q, k, v, lens, alibi=None, causal=False, dtype=np.float32):
    cast = (lambda a: jnp.asarray(a.astype(ml_dtypes.bfloat16))
            if dtype != np.float32 else jnp.asarray(a))
    out = jax_attn.prefill_attention(
        cast(q), cast(k), cast(v),
        None if lens is None else jnp.asarray(lens),
        alibi=None if alibi is None else jnp.asarray(alibi),
        causal=causal)
    return np.asarray(out.astype(jnp.float32))


def _torch(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


def _close(got, want, rel):
    got = got.float().numpy()
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, rel * scale)


@pytest.mark.parametrize("alibi", [False, True], ids=["plain", "alibi"])
@pytest.mark.parametrize("min_s", [2048, 0], ids=["row10", "row12"])
@pytest.mark.parametrize("b,s,hq,hkv,d,lens", CASES)
def test_noncausal_prefill_matches_jax_f32(monkeypatch, min_s, alibi, b, s,
                                           hq, hkv, d, lens):
    """min_s 2048 sends these prompts to row 10's plain version, 0 to row
    12's; every row (pad rows too) within 1e-6 of the largest."""
    monkeypatch.setitem(KERNELS, "prefill_streaming_min_s", min_s)
    q, k, v = _qkv(b, s, hq, hkv, d, seed=s + hq)
    sl = np.asarray(lens, np.int32)
    slopes = attention.alibi_slopes(hq) if alibi else None
    want = _jax(q, k, v, sl, None if slopes is None else slopes.numpy())
    got = attention.prefill_attention(_torch(q), _torch(k), _torch(v),
                                      torch.from_numpy(sl), alibi=slopes,
                                      causal=False)
    assert got.shape == (b, s, hq, d) and got.dtype == torch.float32
    _close(got, want, F32_REL)


@pytest.mark.parametrize("min_s", [2048, 0], ids=["row10", "row12"])
@pytest.mark.parametrize("b,s,hq,hkv,d,lens", CASES[1:3])
def test_noncausal_prefill_matches_jax_bf16(monkeypatch, min_s, b, s, hq,
                                            hkv, d, lens):
    monkeypatch.setitem(KERNELS, "prefill_streaming_min_s", min_s)
    q, k, v = _qkv(b, s, hq, hkv, d, seed=7 * s)
    sl = np.asarray(lens, np.int32)
    want = _jax(q, k, v, sl, dtype=ml_dtypes.bfloat16)
    bf = lambda a: _torch(a.astype(ml_dtypes.bfloat16).astype(np.float32),
                          torch.bfloat16)
    got = attention.prefill_attention(bf(q), bf(k), bf(v),
                                      torch.from_numpy(sl), causal=False)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_REL)


@pytest.mark.parametrize("kernel", ["row10", "row12"])
@pytest.mark.parametrize("b,s,hq,hkv,d,lens", CASES)
def test_plain_kernels_noncausal_match_jax(kernel, b, s, hq, hkv, d, lens):
    """Both plain versions called directly (no seq_lens for the
    full-length case: all S valid)."""
    fn = (_prefill.prefill_attention_kernel_plain if kernel == "row10"
          else _streaming.streaming_prefill_attention_kernel_plain)
    q, k, v = _qkv(b, s, hq, hkv, d, seed=3 * s + d)
    full = all(n == s for n in lens)
    sl = None if full else np.asarray(lens, np.int32)
    want = _jax(q, k, v, sl)
    got = fn(_torch(q), _torch(k), _torch(v),
             None if sl is None else torch.from_numpy(sl), causal=False)
    _close(got, want, F32_REL)


def test_length_zero_averages_v_over_all_rows():
    """A length of 0 masks every column: each row is the mean of V over all
    S, as the JAX package's softmax of a row of NEG_INF gives it."""
    q, k, v = _qkv(1, 40, 2, 2, 32, seed=5)
    lens = torch.tensor([0], dtype=torch.int32)
    mean = v.mean(axis=1, keepdims=True).repeat(40, axis=1)
    for fn in (_prefill.prefill_attention_kernel_plain,
               _streaming.streaming_prefill_attention_kernel_plain):
        got = fn(_torch(q), _torch(k), _torch(v), lens, causal=False)
        np.testing.assert_allclose(got.numpy(), mean, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("min_s", [2048, 0], ids=["row10", "row12"])
def test_causal_default_unchanged(monkeypatch, min_s):
    """No `causal` argument is the causal call, as before, and JAX's."""
    monkeypatch.setitem(KERNELS, "prefill_streaming_min_s", min_s)
    q, k, v = _qkv(2, 66, 4, 2, 64, seed=11)
    sl = np.asarray([66, 30], np.int32)
    want = _jax(q, k, v, sl, causal=True)
    got = attention.prefill_attention(_torch(q), _torch(k), _torch(v),
                                      torch.from_numpy(sl))
    _close(got, want, F32_REL)
    noncausal = attention.prefill_attention(_torch(q), _torch(k), _torch(v),
                                            torch.from_numpy(sl),
                                            causal=False)
    assert not torch.allclose(got, noncausal)


def test_cpu_calls_count_no_launch():
    """The plain versions run for CPU tensors: neither counter moves."""
    before = (_prefill.prefill_attention_kernel.launches,
              _prefill.prefill_attention_kernel.noncausal_launches,
              _streaming.streaming_prefill_attention_kernel.launches,
              _streaming.streaming_prefill_attention_kernel.noncausal_launches)
    q, k, v = (torch.zeros((1, 8, 2, 32)) for _ in range(3))
    _prefill.prefill_attention_kernel(q, k, v, causal=False)
    _streaming.streaming_prefill_attention_kernel(q, k, v, causal=False)
    after = (_prefill.prefill_attention_kernel.launches,
             _prefill.prefill_attention_kernel.noncausal_launches,
             _streaming.streaming_prefill_attention_kernel.launches,
             _streaming.streaming_prefill_attention_kernel.noncausal_launches)
    assert before == after


def _c_params(source, entry):
    """The parameter list of `extern "C" int entry(...)` in csrc/source."""
    text = (ROOT / "trtllm_llama_tpu_torch" / "csrc" / source).read_text()
    m = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", text,
                  re.S)
    assert m, entry
    return [" ".join(p.split()) for p in m.group(1).split(",")]


@pytest.mark.parametrize("source,entry,module", [
    ("prefill_attention.cu", "tllm_prefill_attention", _prefill),
    ("streaming_prefill_attention.cu", "tllm_streaming_prefill_attention",
     _streaming),
])
def test_entry_signature_carries_causal(source, entry, module):
    """The ctypes list names as many arguments as the C entry, and the
    `int causal` flag sits right after D, an int where the wrapper passes
    int(causal)."""
    import ctypes
    params = _c_params(source, entry)
    sig = module._SIGNATURES[entry]
    assert len(params) == len(sig)
    i = params.index("int causal")
    assert params[i - 1] == "int D" and sig[i] is ctypes.c_int
    assert params[i + 1] == "float sm_scale" and sig[i + 1] is ctypes.c_float
