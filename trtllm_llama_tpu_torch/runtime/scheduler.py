"""Continuous-batching request scheduler: queue, slots, admission policy
(the port's copy of the JAX package's `runtime/scheduler.py`, unchanged).

Open design for what the reference ships closed-source — the batch manager
(GptManager/InferenceRequest/batchSlotManager.h, cpp/tensorrt_llm/
batch_manager): a request queue feeding a fixed pool of decode slots, with
admission control against KV capacity, FCFS + no preemption (v1), and
per-request lifecycle callbacks.

The host scheduler is deliberately backend-agnostic: it never touches
device state. ServingEngine (serving.py) owns the device step.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from collections import deque
from typing import Callable, Deque, Dict, List, Optional


class RequestState(enum.Enum):
    QUEUED = 0
    PREFILL = 1
    DECODE = 2
    DONE = 3


@dataclasses.dataclass
class Request:
    request_id: int
    input_ids: List[int]
    max_new_tokens: int
    state: RequestState = RequestState.QUEUED
    slot: Optional[int] = None
    output_ids: List[int] = dataclasses.field(default_factory=list)
    finished_reason: Optional[str] = None     # 'eos' | 'length'

    @property
    def total_len(self) -> int:
        return len(self.input_ids) + len(self.output_ids)


class SlotManager:
    """Fixed pool of decode slots (reference batchSlotManager.h)."""

    def __init__(self, max_slots: int):
        self.max_slots = max_slots
        self._free = list(range(max_slots - 1, -1, -1))
        self._owner: Dict[int, int] = {}

    @property
    def free_count(self) -> int:
        return len(self._free)

    def acquire(self, request_id: int) -> int:
        slot = self._free.pop()
        self._owner[slot] = request_id
        return slot

    def release(self, slot: int):
        del self._owner[slot]
        self._free.append(slot)

    def owner(self, slot: int) -> Optional[int]:
        return self._owner.get(slot)

    def active_slots(self) -> List[int]:
        return sorted(self._owner)


class Scheduler:
    """FCFS admission against slots + KV token capacity."""

    def __init__(self, max_slots: int, max_seq_len: int,
                 kv_token_capacity: Optional[int] = None):
        self.slots = SlotManager(max_slots)
        self.max_seq_len = max_seq_len
        # dense slot cache => capacity is slots*max_seq_len; a paged backend
        # passes its real block budget
        self.kv_token_capacity = (kv_token_capacity
                                  if kv_token_capacity is not None
                                  else max_slots * max_seq_len)
        self._queue: Deque[Request] = deque()
        self._active: Dict[int, Request] = {}
        self._next_id = itertools.count()
        self._reserved_tokens = 0

    # ---- producer side -------------------------------------------------
    def submit(self, input_ids: List[int], max_new_tokens: int) -> int:
        rid = next(self._next_id)
        req = Request(rid, list(input_ids), max_new_tokens)
        if len(input_ids) + max_new_tokens > self.max_seq_len:
            raise ValueError("request exceeds max_seq_len")
        self._queue.append(req)
        return rid

    # ---- engine side ---------------------------------------------------
    def admit(self) -> List[Request]:
        """Move queued requests into free slots while capacity allows."""
        admitted = []
        while self._queue and self.slots.free_count:
            req = self._queue[0]
            need = len(req.input_ids) + req.max_new_tokens
            if self._reserved_tokens + need > self.kv_token_capacity:
                break
            self._queue.popleft()
            req.slot = self.slots.acquire(req.request_id)
            req.state = RequestState.PREFILL
            self._active[req.request_id] = req
            self._reserved_tokens += need
            admitted.append(req)
        return admitted

    def active_requests(self) -> List[Request]:
        return [self._active[self.slots.owner(s)]
                for s in self.slots.active_slots()]

    def get(self, request_id: int) -> Optional[Request]:
        """Look up a queued or in-flight request (public accessor — callers
        should not reach into _active/_queue)."""
        req = self._active.get(request_id)
        if req is not None:
            return req
        for r in self._queue:
            if r.request_id == request_id:
                return r
        return None

    def record_token(self, request_id: int, token: int, eos_id: int) -> bool:
        """Append a generated token; returns True if the request finished."""
        req = self._active[request_id]
        req.output_ids.append(token)
        req.state = RequestState.DECODE
        if token == eos_id:
            req.finished_reason = "eos"
        elif len(req.output_ids) >= req.max_new_tokens:
            req.finished_reason = "length"
        if req.finished_reason:
            self._finish(req)
            return True
        return False

    def _finish(self, req: Request):
        req.state = RequestState.DONE
        self.slots.release(req.slot)
        self._reserved_tokens -= len(req.input_ids) + req.max_new_tokens
        del self._active[req.request_id]

    def finish(self, request_id: int, reason: str):
        """Finish an in-flight request with an engine-decided reason (e.g.
        'stop_words' — stop criteria the engine checks outside
        record_token's eos/length scope)."""
        req = self._active.get(request_id)
        if req is not None:
            req.finished_reason = reason
            self._finish(req)

    def cancel(self, request_id: int):
        for i, r in enumerate(self._queue):
            if r.request_id == request_id:
                del self._queue[i]
                return
        req = self._active.get(request_id)
        if req is not None:
            req.finished_reason = "cancelled"
            self._finish(req)

    @property
    def has_work(self) -> bool:
        return bool(self._queue or self._active)

    @property
    def num_active(self) -> int:
        return len(self._active)

    @property
    def num_queued(self) -> int:
        return len(self._queue)
