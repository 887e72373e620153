"""InferenceSession: single-shot inference for encoder and other
non-autoregressive models (the port's `runtime/single_shot.py`).

The reference's generic `Session` (runtime/session.py:35-180), which its
BERT and UNet examples run instead of GenerationSession: hold the params
on the device and run the model's forward once per input. Optionally the
first array is padded along `pad_axis` up to the next of `buckets`, as
the JAX session pads it so that varying lengths share a handful of
compiled programs (the reference's optimization profiles); padding is
sound only for models that mask by an explicit length argument, as BERT
does. The port runs eagerly, so nothing is compiled or cached per shape.

    sess = InferenceSession(bert.forward, cfg, params, pad_axis=1,
                            buckets=(32, 64, 128), device="cuda")
    hidden = sess.run(input_ids, seq_lens)   # positional, as the model fn

Any callable fn(params, cfg, *tensors, **kwargs) works: positional
arguments (numpy arrays, tensors or lists) go to the session's device,
keyword arguments pass through as they are.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..convert.bridge import tensor_from_numpy
from ..device import resolve_device
from .session import _params_to


class InferenceSession:
    def __init__(self, forward, cfg, params, pad_axis: Optional[int] = None,
                 buckets: Sequence[int] = (), pad_value: int = 0,
                 device="cuda"):
        """forward: fn(params, cfg, *tensors, **kwargs). pad_axis: the axis
        of run()'s first positional argument padded with pad_value up to
        the smallest bucket that holds it (None, or no buckets: run each
        shape as it is)."""
        self.device = resolve_device(device)
        self.forward = forward
        self.cfg = cfg
        self.params = _params_to(params, self.device)
        self.pad_axis = pad_axis
        self.buckets = tuple(sorted(buckets))
        self.pad_value = pad_value

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return n

    def _pad(self, a):
        n = a.shape[self.pad_axis]
        b = self._bucket(n)
        if b == n:
            return a
        shape = list(a.shape)
        shape[self.pad_axis] = b
        out = torch.full(shape, self.pad_value, dtype=a.dtype,
                         device=a.device)
        out.narrow(self.pad_axis, 0, n).copy_(a)
        return out

    def _to_device(self, a):
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        if isinstance(a, np.ndarray):
            return tensor_from_numpy(a, self.device)
        return torch.as_tensor(a, device=self.device)

    def run(self, *args, **kwargs):
        """One inference: the positional arguments on the session's device
        (the first padded to its bucket when configured), the keyword
        arguments as given. Returns the forward's output."""
        arrays = [self._to_device(a) for a in args]
        if arrays and self.pad_axis is not None and self.buckets:
            arrays[0] = self._pad(arrays[0])
        with torch.inference_mode():
            return self.forward(self.params, self.cfg, *arrays, **kwargs)

    def warmup(self, *args, **kwargs):
        """One run on example inputs (the reference's
        Session._prepare_execution); on the card it also builds the
        kernels the forward launches and waits for the device."""
        out = self.run(*args, **kwargs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out
