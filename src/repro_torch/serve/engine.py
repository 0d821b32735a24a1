"""Batched serving engine: slot-based continuous batching over decode_step.

The port of ``repro.serve.engine``, with the same lifecycle. One
``decode_step`` serves a fixed batch of SLOTS; requests stream into free
slots (continuous batching, ``repro_torch.serve.common.SlotPool``). Each
step advances every active slot by one token. Prefill is teacher-forced
token by token through the same decode path, as in the reference.

Stream lifecycle: the position counter is engine-global (lockstep decode),
so a stream ends when ``pos`` reaches ``max_len``. ``run`` then RELEASES
the slots of unfinished requests — a wedged slot must never outlive the
stream that admitted it — and ``reset_stream`` re-arms the engine (fresh
cache, pos 0) for the next stream.

Where the reference donates its cache to a jitted step, the port writes
the cache in place. The engine runs on ``cuda`` unless asked for
``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.models.lm import decode_step, init_cache
from repro_torch.serve.common import SlotPool, SystemClock


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                 # (P,) int32 prompt tokens
    max_new_tokens: int = 16
    out_tokens: Optional[List[int]] = None
    done: bool = False


class ServeEngine:
    def __init__(self, cfg, params, num_slots: int = 4, max_len: int = 512,
                 greedy: bool = True, clock=None, device: DeviceSpec = None):
        self.cfg = cfg
        self.params = params
        # all timing through the injectable clock so a fake clock can
        # drive `run` deterministically
        self.clock = clock if clock is not None else SystemClock()
        self.num_slots = num_slots
        self.max_len = max_len
        self.greedy = greedy
        self.device = resolve_device(device)
        self.cache = init_cache(cfg, num_slots, max_len, self.device)
        # position is tracked PER ENGINE (lockstep decode): slots share the
        # step counter; a slot joining mid-stream gets its prompt fed at the
        # current position
        self.pos = 0
        self.pool: SlotPool = SlotPool(num_slots)
        self._tokens = np.zeros((num_slots, 1), np.int32)

    @property
    def slots(self) -> List[Optional[Request]]:
        """Live view of the slot occupants (index-stable; None = free)."""
        return self.pool.slots

    def submit(self, req: Request) -> bool:
        """Admit `req` into the first free slot; False (busy-rejection, no
        silent queueing, no eviction) while every slot is occupied."""
        req.out_tokens = []
        req._fed = 0                    # prompt tokens fed so far
        if self.pool.acquire(req) is None:
            req.out_tokens = None       # not admitted: leave it unstarted
            return False
        return True

    def step(self) -> None:
        """Advance every active slot by one token."""
        for i, req in enumerate(self.slots):
            if req is None:
                self._tokens[i, 0] = 0
            elif req._fed < len(req.prompt):
                self._tokens[i, 0] = req.prompt[req._fed]
                req._fed += 1
            else:
                self._tokens[i, 0] = req.out_tokens[-1] if req.out_tokens \
                    else req.prompt[-1]
        with torch.no_grad():
            tokens = torch.from_numpy(self._tokens).to(self.device)
            logits, self.cache = decode_step(self.cfg, self.params,
                                             self.cache, tokens, self.pos)
            nxt = logits[:, 0].argmax(dim=-1).cpu().numpy()
        self.pos += 1
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if req._fed >= len(req.prompt):          # generating
                req.out_tokens.append(int(nxt[i]))
                if len(req.out_tokens) >= req.max_new_tokens:
                    req.done = True
                    self.pool.release(i)    # freed THIS step: reusable now

    def run(self, requests: List[Request], max_steps: int = 10_000) -> Dict:
        pending = list(requests)
        t0 = self.clock.now()
        steps = 0
        while (pending or any(s is not None for s in self.slots)) \
                and steps < max_steps and self.pos < self.max_len - 1:
            while pending and self.submit(pending[0]):
                pending.pop(0)
            self.step()
            steps += 1
        evicted = 0
        if self.pos >= self.max_len - 1:
            # stream exhausted: unfinished requests can never advance, so
            # their slots MUST be released (they stay not-done) — leaking
            # them would wedge admission for every later submit/run
            evicted = len(self.pool.release_all())
        return {"steps": steps, "time_s": self.clock.now() - t0,
                "completed": sum(r.done for r in requests),
                "evicted": evicted}

    def reset_stream(self) -> None:
        """Re-arm the engine for a fresh stream: new cache, position 0.
        Refused while a slot is still serving (release/finish first)."""
        busy = sum(1 for s in self.slots if s is not None)
        if busy:
            raise RuntimeError(
                f"reset_stream with {busy} slot(s) still occupied")
        self.cache = init_cache(self.cfg, self.num_slots, self.max_len,
                                self.device)
        self.pos = 0
        self._tokens[:] = 0
