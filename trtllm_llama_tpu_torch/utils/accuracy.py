"""Quantization-accuracy metrics (the port's copy of the JAX package's
`utils/accuracy.py`, which is numpy only; the port keeps its own copy so
that it imports nothing of that package).

The reference gates each quantized engine on CNN/DailyMail ROUGE against
the FP16 HF model (examples/llama/summarize.py; README.md:919-921: a ROUGE
delta of at most ~1). With no checkpoint at hand, the gate is the quantity
ROUGE stands for: how far the quantized model's next-token distribution
moves from the f32 model's, on the engine's own prefill and decode paths.

Per (quant mode, eval batch):
  - top1_agree: share of positions where argmax(quant) == argmax(f32);
  - kl: mean KL(f32 || quant) of the next-token softmax, in nats;
  - ppl_ratio: exp(mean NLL_quant - mean NLL_f32) on continuations the f32
    model produced (> 1: the quantized model predicts them worse);
  - max_abs_err: the largest logit difference (a diagnostic).
Inputs and outputs are numpy; the sums run in float64.
"""

from __future__ import annotations

import numpy as np


def _log_softmax(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float64)
    m = x.max(axis=-1, keepdims=True)
    s = x - m
    return s - np.log(np.exp(s).sum(axis=-1, keepdims=True))


def logit_metrics(ref_logits: np.ndarray, test_logits: np.ndarray) -> dict:
    """Compare two [..., V] logit arrays position by position. Returns
    {'top1_agree', 'kl', 'max_abs_err'}, kl the mean over positions of
    KL(softmax(ref) || softmax(test))."""
    ref = np.asarray(ref_logits, np.float64)
    test = np.asarray(test_logits, np.float64)
    assert ref.shape == test.shape, (ref.shape, test.shape)
    top1 = float((ref.argmax(-1) == test.argmax(-1)).mean())
    lp_ref = _log_softmax(ref)
    lp_test = _log_softmax(test)
    kl = float((np.exp(lp_ref) * (lp_ref - lp_test)).sum(-1).mean())
    return {
        "top1_agree": top1,
        "kl": kl,
        "max_abs_err": float(np.abs(ref - test).max()),
    }


def nll(logits: np.ndarray, targets: np.ndarray) -> float:
    """Mean negative log-likelihood of targets [...] under logits [..., V]."""
    lp = _log_softmax(np.asarray(logits, np.float64))
    t = np.asarray(targets)
    picked = np.take_along_axis(lp, t[..., None], axis=-1)[..., 0]
    return float(-picked.mean())


def ppl_ratio(ref_logits: np.ndarray, test_logits: np.ndarray,
              targets: np.ndarray) -> float:
    """exp(NLL_test - NLL_ref) on the same targets: > 1.0 means the
    quantized model is worse. Scale-free, so one threshold holds across
    model sizes."""
    return float(np.exp(nll(test_logits, targets) - nll(ref_logits, targets)))
