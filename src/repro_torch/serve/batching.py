"""Continuous-batching manager: slot + KV-budget accounting (twin of
``repro.serve.batching``, SERVING.md).

The live batch is ``max_batch`` *slots* of one decode step; every step,
each active slot consumes exactly one token — the next prompt token while
the request is prefilling, else its last sampled token — so prefill and
decode interleave in the same step.

Invariants (enforced here, asserted by tests/test_torch_disagg.py against
the reference's managers):
  * at most ``max_batch`` slots are active;
  * the sum of active KV reservations (prompt_len + max_new per request)
    never exceeds ``kv_budget`` tokens;
  * a request only admits if it can ever fit (kv_tokens <= max_seq);
  * finishing a request frees its slot and its reservation the same step;
  * admission is strict FIFO (head-of-line blocking, no starvation).

Disaggregated serving (DESIGN.md §13) splits the manager into fleet roles:
a ``role="prefill"`` manager admits arrivals and streams prompts until the
first token is sampled, then parks the sequence *handoff-ready* (slot and
KV reservation held — back-pressure, not loss — until the bounded
:class:`HandoffBuffer` stages its KV payload); a ``role="decode"`` manager
has no arrival queue and admits only transferred sequences.  The default
``role="unified"`` keeps the co-located behavior bit-identical.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, List, Optional

import numpy as np

from ..engine.config import ServeConfig
from .request import Request

__all__ = ["ActiveSeq", "BatchManager", "HandoffBuffer", "HandoffItem"]


@dataclasses.dataclass
class ActiveSeq:
    """One admitted request bound to a decode slot."""

    request: Request
    slot: int
    admit_step: int
    fed: int = 0                       # tokens the model has consumed
    tokens: Optional[list] = None      # generated token ids
    first_token_step: int = -1
    first_token_wall: float = 0.0
    # prefill fleet only (DESIGN.md §13): first token sampled, parked in
    # its slot until the handoff buffer stages its KV payload
    handoff_ready: bool = False

    def __post_init__(self):
        if self.tokens is None:
            self.tokens = []

    @property
    def prefilling(self) -> bool:
        return self.fed < self.request.prompt_len

    def next_token(self) -> int:
        """Token this slot feeds the model on the coming step."""
        if self.prefilling:
            return int(self.request.prompt[self.fed])
        return self.tokens[-1]


_ROLES = ("unified", "prefill", "decode")


class BatchManager:
    """Admit/evict sequences per decode step against a fixed KV budget.

    ``role`` selects the fleet behavior (module docstring): "unified"
    (default, the co-located loop), "prefill" (parks sequences
    handoff-ready at their first sampled token), or "decode" (admits only
    via :meth:`admit_transfer`, never from the arrival queue)."""

    def __init__(self, cfg: ServeConfig, role: str = "unified"):
        if role not in _ROLES:
            raise ValueError(f"BatchManager role {role!r} not in {_ROLES}")
        self.cfg = cfg
        self.role = role
        self.slots: List[Optional[ActiveSeq]] = [None] * cfg.max_batch
        self.queue: Deque[Request] = deque()
        self.reserved_tokens = 0
        self.rejected: List[Request] = []
        # elastic fleets (FLEET.md): admission restricted to the slot
        # prefix [0, slot_limit).  None = every slot.  Shrinking the limit
        # never evicts — sequences already above it finish in place (the
        # drain-grace contract); the physical batch width (the decode
        # step shape) never changes.
        self.slot_limit: Optional[int] = None

    # ------------------------------------------------------------ intake
    def submit(self, request: Request) -> bool:
        """Queue a request; oversize requests (could never fit a slot) are
        rejected immediately and recorded, not raised."""
        if self.role == "decode":
            raise ValueError("decode-fleet managers admit only transferred "
                             "sequences (admit_transfer), not raw requests")
        if request.kv_tokens > self.cfg.max_seq:
            self.rejected.append(request)
            return False
        self.queue.append(request)
        return True

    # -------------------------------------------------------- accounting
    @property
    def active(self) -> List[ActiveSeq]:
        return [s for s in self.slots if s is not None]

    @property
    def n_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    @property
    def cached_tokens(self) -> int:
        """Tokens actually resident in the KV caches right now."""
        return sum(s.fed for s in self.slots if s is not None)

    @property
    def admit_capacity(self) -> int:
        """Slots admission may use right now (elastic fleets shrink this
        below ``max_batch`` while a group is draining)."""
        return (len(self.slots) if self.slot_limit is None
                else self.slot_limit)

    def set_slot_limit(self, limit: Optional[int]) -> None:
        """Restrict admission to slots [0, limit) — the elastic fleet's
        capacity mask (FLEET.md).  Never touches in-flight sequences."""
        if limit is not None and not 0 <= limit <= len(self.slots):
            raise ValueError(
                f"slot_limit={limit} outside [0, {len(self.slots)}]")
        self.slot_limit = limit

    def n_active_above(self, limit: int) -> int:
        """In-flight sequences occupying slots >= ``limit`` — a draining
        group's stragglers; 0 means the drain may complete."""
        return sum(1 for s in self.slots[limit:] if s is not None)

    # --------------------------------------------------- crash recovery
    def evict_range(self, lo: int, hi: int) -> List[ActiveSeq]:
        """Forcibly evict every in-flight sequence in slots [lo, hi) — an
        unplanned group crash (RESILIENCE.md): their KV is *lost*, slots
        and reservations are freed now.  Contrast the drain path, which
        only masks admission and lets sequences finish in place.  Returns
        the victims in slot order; the caller owns retry accounting and
        re-enqueue (:meth:`requeue_front`)."""
        if not 0 <= lo <= hi <= len(self.slots):
            raise ValueError(f"evict_range [{lo}, {hi}) outside "
                             f"[0, {len(self.slots)}]")
        victims: List[ActiveSeq] = []
        for i in range(lo, hi):
            s = self.slots[i]
            if s is None:
                continue
            self.slots[i] = None
            self.reserved_tokens -= s.request.kv_tokens
            victims.append(s)
        assert self.reserved_tokens >= 0
        return victims

    def requeue_front(self, requests: List[Request]) -> None:
        """Re-enqueue crash victims at the *head* of the FIFO, preserving
        their relative order — recovered requests re-prefill before any
        later arrival, so global FIFO admission order survives the crash
        (every queued request arrived no earlier than any evicted one)."""
        if self.role == "decode":
            raise ValueError("decode-fleet managers admit only transferred "
                             "sequences; requeue on the prefill side")
        for req in reversed(requests):
            self.queue.appendleft(req)

    def has_work(self) -> bool:
        return bool(self.queue) or self.n_active > 0

    def next_arrival_step(self) -> Optional[int]:
        return self.queue[0].arrival_step if self.queue else None

    # --------------------------------------------------------- admission
    def admit_ready(self, step: int) -> np.ndarray:
        """Admit queued requests that have arrived (arrival_step <= step),
        strict FIFO, while a slot is free and the KV reservation fits the
        budget.  Returns bool[max_batch]: slots that must be cache-reset
        (the admit hook for ``decoder.reset_decode_slots``)."""
        mask = np.zeros(self.cfg.max_batch, bool)
        while self.queue and self.queue[0].arrival_step <= step:
            req = self.queue[0]
            free = next((i for i, s in
                         enumerate(self.slots[:self.admit_capacity])
                         if s is None), None)
            if free is None:
                break
            if self.reserved_tokens + req.kv_tokens > self.cfg.budget_tokens:
                break
            self.queue.popleft()
            self.slots[free] = ActiveSeq(request=req, slot=free,
                                         admit_step=step)
            self.reserved_tokens += req.kv_tokens
            mask[free] = True
        assert self.reserved_tokens <= self.cfg.budget_tokens
        return mask

    # ----------------------------------------------------------- tokens
    def next_tokens(self) -> tuple:
        """(int64[max_batch, 1] tokens to feed, bool[max_batch] active)."""
        toks = np.zeros((self.cfg.max_batch, 1), np.int64)
        act = np.zeros(self.cfg.max_batch, bool)
        for i, s in enumerate(self.slots):
            if s is not None and not s.handoff_ready:
                # handoff-ready sequences are stalled (buffer back-pressure):
                # they hold their slot but feed nothing
                toks[i, 0] = s.next_token()
                act[i] = True
        return toks, act

    def observe(self, sampled: np.ndarray, step: int,
                wall: float) -> List[ActiveSeq]:
        """Account one decode step's sampled tokens (int[max_batch]).

        Advances every active slot by the one token it fed; a slot whose
        prompt is now fully consumed takes ``sampled[slot]`` as its next
        generated token.  Returns sequences that finished this step (their
        slots and KV reservations are already freed)."""
        finished: List[ActiveSeq] = []
        for i, s in enumerate(self.slots):
            if s is None or s.handoff_ready:
                continue                     # stalled slots fed nothing
            s.fed += 1
            if s.prefilling:
                continue                     # still streaming the prompt in
            tok = int(sampled[i])
            if not s.tokens:
                s.first_token_step = step
                s.first_token_wall = wall
            s.tokens.append(tok)
            done = (len(s.tokens) >= s.request.max_new
                    or (self.cfg.eos_token is not None
                        and tok == self.cfg.eos_token))
            if done:
                self.slots[i] = None
                self.reserved_tokens -= s.request.kv_tokens
                finished.append(s)
            elif self.role == "prefill":
                # prefill's job ends at the first token (TTFT); park the
                # sequence for KV handoff, holding slot + reservation
                s.handoff_ready = True
        assert self.reserved_tokens >= 0
        return finished

    # ----------------------------------------- prefill/decode handoff
    def take_handoff_ready(self) -> List[ActiveSeq]:
        """Handoff-ready sequences in slot order (prefill fleet).  The
        caller stages each into the :class:`HandoffBuffer` while it has
        space and then frees the slot with :meth:`release`."""
        return [s for s in self.slots
                if s is not None and s.handoff_ready]

    def release(self, seq: ActiveSeq) -> None:
        """Free a handoff-ready sequence's slot + KV reservation — the
        send side of the boundary, once its payload is staged."""
        assert self.slots[seq.slot] is seq and seq.handoff_ready
        self.slots[seq.slot] = None
        self.reserved_tokens -= seq.request.kv_tokens
        assert self.reserved_tokens >= 0

    def can_admit_transfer(self, seq: ActiveSeq) -> bool:
        """Whether :meth:`admit_transfer` would succeed right now — lets
        the loop decide a transfer *attempt* occurs (and e.g. draw a
        fault verdict for it) before binding the slot."""
        if not any(s is None for s in self.slots[:self.admit_capacity]):
            return False
        return (self.reserved_tokens + seq.request.kv_tokens
                <= self.cfg.budget_tokens)

    def admit_transfer(self, seq: ActiveSeq, step: int) -> Optional[int]:
        """Bind a transferred sequence to a free decode slot (decode
        fleet).  Returns the slot, or None when no slot is free or the KV
        reservation would exceed the budget (the sequence stays staged in
        the handoff buffer)."""
        assert self.role == "decode", "admit_transfer is decode-fleet only"
        free = next((i for i, s in
                     enumerate(self.slots[:self.admit_capacity])
                     if s is None), None)
        if free is None:
            return None
        if self.reserved_tokens + seq.request.kv_tokens > \
                self.cfg.budget_tokens:
            return None
        seq.slot = free
        seq.handoff_ready = False
        self.slots[free] = seq
        self.reserved_tokens += seq.request.kv_tokens
        assert self.reserved_tokens <= self.cfg.budget_tokens
        return free


@dataclasses.dataclass
class HandoffItem:
    """One staged prefill->decode transfer: the sequence plus its
    extracted per-slot KV payload (``models.decoder.extract_decode_slot``,
    or None in manager-level simulations)."""

    seq: ActiveSeq
    payload: Any = None
    kv_bytes: int = 0
    push_step: int = -1
    # transfer-failure retry state (RESILIENCE.md): attempts failed so
    # far, and the step before which no retry may be attempted (capped
    # exponential backoff — the item stays staged, never dropped)
    retries: int = 0
    next_attempt_step: int = 0


class HandoffBuffer:
    """Bounded FIFO staging buffer on the prefill/decode boundary
    (DESIGN.md §13).

    ``push`` stages a completed prefill's KV payload (False when full —
    the sequence then stalls in its prefill slot: back-pressure, never
    loss); ``pop`` hands the eldest transfer to the decode fleet.  Depth
    bounds the staged-KV memory; the occupancy invariant (never above
    ``depth``) is asserted here and property-tested in
    tests/test_torch_disagg.py."""

    def __init__(self, depth: int):
        if depth < 1:
            raise ValueError(f"HandoffBuffer depth must be >= 1, "
                             f"got {depth}")
        self.depth = int(depth)
        self.items: Deque[HandoffItem] = deque()
        self.transferred = 0               # pops, i.e. completed handoffs
        self.peak = 0                      # max occupancy seen
        self.bytes_total = 0               # staged KV bytes, cumulative

    def __len__(self) -> int:
        return len(self.items)

    @property
    def full(self) -> bool:
        return len(self.items) >= self.depth

    def push(self, item: HandoffItem) -> bool:
        if self.full:
            return False
        self.items.append(item)
        self.peak = max(self.peak, len(self.items))
        self.bytes_total += int(item.kv_bytes)
        assert len(self.items) <= self.depth
        return True

    def peek(self) -> Optional[HandoffItem]:
        return self.items[0] if self.items else None

    def pop(self) -> HandoffItem:
        item = self.items.popleft()
        self.transferred += 1
        return item
