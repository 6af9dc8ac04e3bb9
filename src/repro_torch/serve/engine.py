"""Batched serving engine: prefill + continuous decode over request slots.

The port of the JAX package's `serve/engine.py`, with its semantics kept
exactly: a fixed pool of `batch` slots, each holding one request's cache
region; a new request is prefilled token by token into a free slot with
the decode step (one program for both), and every tick decodes one token
for all active slots at one shared position, the largest of the active
slots' positions.  Finished slots (EOS, budget or max_len) are recycled.
Spans and counters go to `tracer` (`repro_torch.obs`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import as_device
from ..models import decode_step, init_cache
from ..obs import NULL_TRACER


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray               # [S] int32
    max_new_tokens: int = 16
    out_tokens: Optional[List[int]] = None


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, batch: int = 4,
                 max_len: int = 256, eos_id: int = -1,
                 greedy: bool = True, tracer=None, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.device = as_device(device)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.batch = batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.cache = init_cache(cfg, batch, max_len, device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * batch
        self.slot_pos = np.zeros(batch, np.int32)
        self.slot_budget = np.zeros(batch, np.int32)
        self.pending: List[Request] = []
        self.done: Dict[int, Request] = {}
        self._decode = lambda p, c, t, i: decode_step(p, cfg, c, t, i)

    def _tokens(self, toks: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(toks).to(self.device)

    # -- admission ---------------------------------------------------------
    def submit(self, req: Request):
        # a zero-length prompt has no last-token logits to seed decoding
        # from (`_prefill_slot` derives the first output from the final
        # prefill step) — reject at admission rather than crash mid-tick
        if len(req.prompt) == 0:
            raise ValueError(
                f"request {req.rid}: empty prompt — prefill needs at "
                f"least one token to seed decoding (prepend a BOS id)")
        req.out_tokens = []
        self.pending.append(req)

    def _admit(self):
        for i in range(self.batch):
            if self.slot_req[i] is None and self.pending:
                req = self.pending.pop(0)
                self._prefill_slot(i, req)

    def _prefill_slot(self, slot: int, req: Request):
        # teacher-forced token-by-token prefill into this slot's cache
        # region, as the reference does (one decode program for both)
        with self.tracer.span("serve.prefill", rid=req.rid, slot=slot,
                              tokens=len(req.prompt)):
            for j, tok in enumerate(req.prompt):
                t = np.zeros((self.batch,), np.int32)
                t[slot] = tok
                logits, self.cache = self._decode(
                    self.params, self.cache, self._tokens(t), int(j))
            self.slot_req[slot] = req
            self.slot_pos[slot] = len(req.prompt)
            self.slot_budget[slot] = req.max_new_tokens
            last = logits[slot].float().cpu().numpy()
            req.out_tokens.append(int(last.argmax()))

    # -- decode tick ---------------------------------------------------------
    def step(self):
        with self.tracer.span("serve.tick", phase=True) as tick:
            with self.tracer.span("serve.admit"):
                self._admit()
            active = [i for i in range(self.batch)
                      if self.slot_req[i] is not None]
            self.tracer.metrics.gauge("serve.slots_active").set(len(active))
            tick.set(active=len(active))
            if not active:
                return False
            toks = np.zeros((self.batch,), np.int32)
            for i in active:
                toks[i] = self.slot_req[i].out_tokens[-1]
            pos = int(max(self.slot_pos[i] for i in active))
            # the copy to the host inside the span: the device time of the
            # decode lands in the span that launched it
            with self.tracer.span("serve.decode", active=len(active),
                                  pos=pos):
                logits, self.cache = self._decode(self.params, self.cache,
                                                  self._tokens(toks), pos)
                logits = logits.float().cpu().numpy()
            for i in active:
                req = self.slot_req[i]
                nxt = int(logits[i].argmax())
                req.out_tokens.append(nxt)
                self.slot_pos[i] += 1
                self.slot_budget[i] -= 1
                if (nxt == self.eos_id or self.slot_budget[i] <= 0
                        or self.slot_pos[i] >= self.max_len - 1):
                    self.done[req.rid] = req
                    self.slot_req[i] = None
            self.tracer.metrics.counter("serve.tokens_decoded").inc(
                len(active))
            return True

    def run_until_drained(self, max_ticks: int = 10_000):
        ticks = 0
        while (self.pending or any(r is not None for r in self.slot_req)) \
                and ticks < max_ticks:
            self.step()
            ticks += 1
        return ticks
