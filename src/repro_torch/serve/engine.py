"""Continuous-batching decode engine over per-user ZO adapters.

Port of the JAX package's ``serve/engine.py``: dense mode, paged mode
with whole-prompt or chunked admission, and self-speculative decoding
over the paged cache.

A fixed table of ``n_slots`` sequence slots shares one batched decode
cache. Requests queue up; whenever a slot is free the next request is
admitted mid-flight: its adapter is materialized through the
:class:`~repro_torch.serve.adapters.AdapterStore`, its prompt prefilled,
and finished sequences free their slot on the spot. Every decode step
advances all active slots one token, each at its own position, with one
decode dispatch per distinct active adapter (masked slots keep their
cache entries: trash-page writes in paged mode, old entries in dense
mode).

Paged KV (``paged=True``): attention K/V lives in a shared pool of
fixed-size pages with a per-slot page table. Pages are reserved at
admission (the request's worst case) and allocated as the sequence
reaches them; decode reads only live pages -- the ``flash_decode`` kernel
on the card -- with the live page count bucketed to powers of two.
Physical page 0 is the trash page.

Chunked prefill (``prefill_chunk=C``, paged only): at most one admission
in flight, advanced at most ``C`` prompt tokens per engine step straight
into the slot's reserved pages (the ``flash_prefill`` kernel on the card)
while every decoding slot still advances one token per step. Tail chunks
decompose into powers of two (13 -> 8 + 4 + 1) and the live page count
is bucketed, as in the JAX engine: eager PyTorch does not need the
bounded shapes, but they keep the port's logits computed on the same
chunks as the JAX package's. Greedy output is bit-identical to
whole-prompt admission.

Speculative decoding (``spec_k``, paged only): the engine's own frozen
base weights (``store.materialize(None)``, the int8 base when quantized)
draft, so speculation adds no weight bytes. Each round the base drafts
up to ``k`` tokens per slot greedily (chained ``decode_step`` calls,
``flash_decode`` on the card), writing its K/V into the slot's reserved
pages; one ``verify_window`` call per distinct active user then scores
the k + 1 window positions with that user's weights (``flash_verify``),
overwriting the window's K/V with the target's own, so the pool holds
what a sequential target decode would have cached. The longest draft
prefix matching the target's greedy choices is committed with the
target's correction or bonus token: greedy output equals the plain
engine's. Rejected positions need no rollback: reads stop at each
row's position and the next round overwrites them before they are
read. Sampled slots run speculative rejection sampling against the
greedy draft (:func:`~repro_torch.serve.sampling.spec_accept`), which
keeps the target's top-k distribution. A slot drafts at most
``remaining`` tokens, so its writes stay inside its reservation.

All state lives on the engine's ``device`` (``"cuda"`` unless the caller
asks for the CPU); the page tables and bookkeeping live on the host.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import build_model
from repro_torch.models.transformer import resolve_device
from repro_torch.serve import sampling
from repro_torch.serve.adapters import AdapterStore


@dataclasses.dataclass
class Request:
    """One generation request, tagged with the adapter that serves it."""
    prompt: np.ndarray            # (P,) int32 token ids
    max_new: int
    user: Optional[str] = None    # adapter id; None -> base weights
    greedy: bool = True
    topk: int = 0                 # used when greedy=False
    temperature: float = 1.0
    rid: int = -1                 # assigned by submit()
    submit_ts: Optional[float] = None     # stamped by submit()


@dataclasses.dataclass
class Completion:
    rid: int
    user: Optional[str]
    prompt: np.ndarray
    tokens: np.ndarray            # (n_generated,) int32
    accept_rate: Optional[float] = None   # draft acceptance (spec mode)
    queue_wait_s: float = 0.0     # submit -> admission start
    ttft_s: float = 0.0           # submit -> first token picked


@dataclasses.dataclass
class EngineStats:
    prefill_tokens: int = 0
    prefill_s: float = 0.0
    decode_tokens: int = 0
    decode_s: float = 0.0
    decode_steps: int = 0
    admitted: int = 0
    finished: int = 0
    peak_active_slots: int = 0
    peak_pages_in_use: int = 0    # paged mode only (excludes trash page)
    spec_drafted: int = 0         # draft tokens proposed (spec mode)
    spec_accepted: int = 0        # draft tokens accepted and committed
    # slot-seconds active decode slots sat idle while admission prefill
    # work ran
    decode_stall_s: float = 0.0
    queue_wait_s: float = 0.0     # summed over admissions
    ttft_s: float = 0.0           # summed over admissions

    @staticmethod
    def _rate(num: float, den: float) -> float:
        return num / den if den > 0 else 0.0

    @property
    def prefill_tps(self) -> float:
        return self._rate(self.prefill_tokens, self.prefill_s)

    @property
    def decode_tps(self) -> float:
        return self._rate(self.decode_tokens, self.decode_s)

    @property
    def spec_accept_rate(self) -> float:
        return self._rate(self.spec_accepted, self.spec_drafted)


class ServeEngine:
    def __init__(self, cfg, store: AdapterStore, n_slots: int = 4,
                 max_len: Optional[int] = None, seed: int = 0,
                 paged: bool = False, page_size: int = 16,
                 pool_pages: Optional[int] = None,
                 spec_k: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        if store.device.type != self.device.type:
            raise ValueError(f"adapter store lives on {store.device}, the "
                             f"engine on {self.device}")
        self.model = build_model(cfg)
        if spec_k is not None and spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if spec_k is not None and not paged:
            raise ValueError(
                "spec_k requires paged=True: the draft writes into (and "
                "the verifier overwrites) the slot's shared KV pages")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if prefill_chunk is not None and not paged:
            raise ValueError(
                "prefill_chunk requires paged=True: prompt chunks write "
                "straight into the slot's reserved KV pages")
        self.store = store
        self.n_slots = n_slots
        self.max_len = max_len or cfg.max_seq
        self.generator = torch.Generator().manual_seed(seed)
        self.stats = EngineStats()
        self.paged = bool(paged and self.model.init_paged_cache is not None)
        if spec_k is not None and not self.paged:
            raise ValueError(
                f"family {cfg.family!r} has no pageable state; speculative "
                f"decoding needs a paged KV cache to share between draft "
                f"and verifier")
        self.spec_k = int(spec_k or 0)
        self.prefill_chunk = int(prefill_chunk or 0)
        self.page_size = page_size
        if self.paged:
            self.slot_pages = -(-self.max_len // page_size)  # per-slot max
            if pool_pages is None:       # default: dense capacity + trash
                pool_pages = n_slots * self.slot_pages + 1
            if pool_pages < 2:
                raise ValueError("pool_pages must be >= 2 (trash + 1)")
            self.pool_pages = pool_pages
            self.cache = self.model.init_paged_cache(
                n_slots, pool_pages, page_size, max_len=self.max_len,
                device=self.device)
            self._free_pages = list(range(pool_pages - 1, 0, -1))
            self._reserved = 0                     # pages promised, total
            self._slot_alloc: List[List[int]] = [[] for _ in range(n_slots)]
            self._slot_reserve = np.zeros(n_slots, np.int64)
            self._table = np.zeros((n_slots, self.slot_pages), np.int32)
        else:
            self.cache = self.model.init_cache(n_slots, self.max_len,
                                               device=self.device)

        self.queue: deque = deque()
        self._next_rid = 0
        self._req: List[Optional[Request]] = [None] * n_slots
        self._active = np.zeros(n_slots, bool)
        self._pos = np.zeros(n_slots, np.int32)
        self._remaining = np.zeros(n_slots, np.int32)
        self._last = np.zeros(n_slots, np.int32)
        self._out: List[List[int]] = [[] for _ in range(n_slots)]
        self._slot_drafted = np.zeros(n_slots, np.int64)
        self._slot_accepted = np.zeros(n_slots, np.int64)
        self._queue_wait = np.zeros(n_slots)
        self._ttft = np.zeros(n_slots)
        self._prefill_slot: Optional[int] = None   # chunked: slot mid-prefill
        self._prefill_off = 0                      # prompt tokens done so far
        self._finished: List[Completion] = []

    # ---- host <-> device ---------------------------------------------------
    def _dev(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(
            self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- page pool -------------------------------------------------------
    def _pages_needed(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    def _alloc_page(self, slot: int) -> None:
        page = self._free_pages.pop()
        lp = len(self._slot_alloc[slot])
        self._slot_alloc[slot].append(page)
        self._table[slot, lp] = page
        in_use = self.pool_pages - 1 - len(self._free_pages)
        self.stats.peak_pages_in_use = max(self.stats.peak_pages_in_use,
                                           in_use)

    def _release_slot_pages(self, slot: int) -> None:
        self._free_pages.extend(reversed(self._slot_alloc[slot]))
        self._reserved -= int(self._slot_reserve[slot])
        self._slot_reserve[slot] = 0
        self._slot_alloc[slot] = []
        self._table[slot] = 0                      # -> trash page

    # ---- request lifecycle ----------------------------------------------
    def submit(self, req: Request) -> int:
        plen = int(np.asarray(req.prompt).size)
        if plen + req.max_new > self.max_len:
            raise ValueError(f"prompt({plen}) + max_new({req.max_new}) "
                             f"exceeds max_len({self.max_len})")
        if req.max_new < 1:
            raise ValueError("max_new must be >= 1")
        if self.paged:
            need = self._pages_needed(plen + req.max_new)
            if need > self.pool_pages - 1:
                raise ValueError(
                    f"request needs {need} pages "
                    f"({plen}+{req.max_new} tokens @ page_size "
                    f"{self.page_size}); pool holds {self.pool_pages - 1}")
        req.rid = self._next_rid
        self._next_rid += 1
        if req.submit_ts is None:
            req.submit_ts = time.perf_counter()
        self.queue.append(req)
        return req.rid

    def _free_slots(self) -> List[int]:
        return [i for i in range(self.n_slots) if not self._active[i]]

    def _install(self, fresh, slot: int) -> None:
        """Scatter a B=1 prefilled dense cache into slot ``slot``: pool
        leaves (``X_pages``) page their dense twin ``X`` into the slot's
        physical pages; dense leaves install the row prefix."""
        sub, fsub = self.cache[self.model.plan.stack.scope], \
            fresh[self.model.plan.stack.scope]
        for mixer, leaves in sub.items():
            for name, c in leaves.items():
                if name.endswith("_pages"):
                    row = fsub[mixer][name[:-len("_pages")]]  # (L,1,S,...)
                    phys = self._dev(self._slot_alloc[slot], torch.long)
                    npg, ps = phys.shape[0], c.shape[2]
                    src = row[:, 0, :npg * ps].reshape(
                        (row.shape[0], npg, ps) + tuple(row.shape[3:]))
                    c[:, phys] = src.to(c.dtype)
                else:
                    row = fsub[mixer][name]
                    c[:, slot, :row.shape[2]] = row[:, 0].to(c.dtype)

    def _admit(self):
        """Prefill queued requests into free slots (mid-flight). Paged
        mode additionally requires the request's worst-case page count to
        fit in the unreserved pool. FIFO: a head request that does not
        fit blocks the queue until slots/pages free up."""
        if self.prefill_chunk:
            return self._admit_chunked()
        for slot in self._free_slots():
            if not self.queue:
                return
            req = self.queue[0]
            plen = int(np.asarray(req.prompt).size)
            if self.paged:
                need = self._pages_needed(plen + req.max_new)
                if self._reserved + need > self.pool_pages - 1:
                    return                       # wait for pages to free
            self.queue.popleft()
            params = self.store.materialize(req.user)
            prompt = self._dev(np.asarray(req.prompt).reshape(1, -1),
                               torch.long)
            t0 = time.perf_counter()
            self._queue_wait[slot] = (
                t0 - req.submit_ts if req.submit_ts is not None else 0.0)
            if self.paged:
                self._reserved += need
                self._slot_reserve[slot] = need
                n_prompt_pages = self._pages_needed(plen)
                for _ in range(n_prompt_pages):
                    self._alloc_page(slot)
                fresh_len = n_prompt_pages * self.page_size
            else:
                fresh_len = min(1 << max(plen - 1, 0).bit_length(),
                                self.max_len)
            fresh = self.model.init_cache(1, fresh_len, device=self.device)
            logits, fresh = self.model.prefill(params, fresh, prompt)
            self._install(fresh, slot)
            row = logits[0, -1].float().cpu().numpy()
            elapsed = time.perf_counter() - t0
            self.stats.prefill_s += elapsed
            self.stats.decode_stall_s += elapsed * int(self._active.sum())
            self.stats.prefill_tokens += plen
            self.stats.admitted += 1
            self._activate(slot, req, row, plen)

    def _admit_chunked(self):
        """Chunked admission: at most one prompt in flight, advanced at
        most ``prefill_chunk`` tokens per engine step straight into the
        slot's reserved pages. All prompt pages are allocated up front,
        so every chunk's writes land in live pages."""
        if self._prefill_slot is None:
            free = self._free_slots()
            if free and self.queue:
                req = self.queue[0]
                plen = int(np.asarray(req.prompt).size)
                need = self._pages_needed(plen + req.max_new)
                if self._reserved + need <= self.pool_pages - 1:
                    self.queue.popleft()
                    slot = free[0]
                    now = time.perf_counter()
                    self._queue_wait[slot] = (
                        now - req.submit_ts if req.submit_ts is not None
                        else 0.0)
                    self._reserved += need
                    self._slot_reserve[slot] = need
                    for _ in range(self._pages_needed(plen)):
                        self._alloc_page(slot)
                    self._req[slot] = req
                    self._prefill_slot = slot
                    self._prefill_off = 0
                    self.stats.admitted += 1
        if self._prefill_slot is None:
            return
        slot = self._prefill_slot
        req = self._req[slot]
        prompt = np.asarray(req.prompt, np.int32)
        plen = prompt.size
        params = self.store.materialize(req.user)
        n_live = 1
        while n_live < len(self._slot_alloc[slot]):
            n_live *= 2
        n_live = min(n_live, self.slot_pages)
        pages = self._dev(self._table[slot:slot + 1, :n_live])
        budget = self.prefill_chunk
        t0 = time.perf_counter()
        done = 0
        logits = None
        while budget > 0 and self._prefill_off < plen:
            c = min(plen - self._prefill_off, budget)
            if c < self.prefill_chunk:   # pow2 tail pieces
                c = 1 << (c.bit_length() - 1)
            end = self._prefill_off + c
            logits, self.cache = self.model.prefill_chunk(
                params, self.cache,
                self._dev(prompt[None, self._prefill_off:end], torch.long),
                self._dev([self._prefill_off]), pages=pages)
            self._prefill_off = end
            budget -= c
            done += c
        self._sync()
        elapsed = time.perf_counter() - t0
        self.stats.prefill_s += elapsed
        self.stats.decode_stall_s += elapsed * int(self._active.sum())
        self.stats.prefill_tokens += done
        if self._prefill_off < plen:
            return                       # more chunks next step
        self._prefill_slot = None
        self._activate(slot, req, logits[0, -1].float().cpu().numpy(), plen)

    def _activate(self, slot: int, req: Request, logits_row: np.ndarray,
                  plen: int):
        """Hand a fully prefilled slot to decode: pick the first token,
        mark the slot active, record time-to-first-token. One generator
        split per admission in both admission modes keeps greedy (and the
        per-admission sampling stream) identical between them."""
        gens = sampling.step_keys(self.generator, self.n_slots)
        tok = self._pick(req, gens[slot], logits_row)
        now = time.perf_counter()
        self._ttft[slot] = (now - req.submit_ts
                            if req.submit_ts is not None else 0.0)
        self.stats.queue_wait_s += float(self._queue_wait[slot])
        self.stats.ttft_s += float(self._ttft[slot])
        self._req[slot] = req
        self._active[slot] = True
        self._pos[slot] = plen
        self._remaining[slot] = req.max_new - 1
        self._last[slot] = tok
        self._out[slot] = [tok]
        self._slot_drafted[slot] = 0
        self._slot_accepted[slot] = 0
        self.stats.peak_active_slots = max(self.stats.peak_active_slots,
                                           int(self._active.sum()))
        if self._remaining[slot] == 0:
            self._finish(slot)

    def _pick(self, req: Request, generator, logits_row: np.ndarray) -> int:
        if req.greedy:
            return int(logits_row.argmax())
        tok = sampling.sample_topk([generator],
                                   torch.from_numpy(logits_row)[None],
                                   req.topk or logits_row.size,
                                   req.temperature)
        return int(tok[0])

    def _finish(self, slot: int):
        req = self._req[slot]
        drafted = int(self._slot_drafted[slot])
        self._finished.append(Completion(
            rid=req.rid, user=req.user, prompt=np.asarray(req.prompt),
            tokens=np.asarray(self._out[slot], np.int32),
            accept_rate=(int(self._slot_accepted[slot]) / drafted
                         if drafted else None),
            queue_wait_s=float(self._queue_wait[slot]),
            ttft_s=float(self._ttft[slot])))
        self._active[slot] = False
        self._req[slot] = None
        if self.paged:
            self._release_slot_pages(slot)
        self.stats.finished += 1

    # ---- decode ---------------------------------------------------------
    def _live_pages(self, cover: np.ndarray) -> torch.Tensor:
        """Grow page tables to cover this step's highest write position
        per slot (plain decode: ``pos``; speculative rounds: ``pos + d``,
        which the admission reservation still covers), then return the
        (n_slots, n_live) table slice spanning every live page -- n_live
        bucketed to powers of two."""
        for slot in np.flatnonzero(self._active):
            while (len(self._slot_alloc[slot])
                   <= cover[slot] // self.page_size):
                self._alloc_page(slot)          # reservation guarantees one
        maxp = 1 + int(cover[self._active].max()) // self.page_size
        n_live = 1
        while n_live < maxp:
            n_live *= 2
        n_live = min(n_live, self.slot_pages)
        return self._dev(self._table[:, :n_live])

    def _commit(self, slot: int, toks: List[int]) -> None:
        self._out[slot].extend(toks)
        self._last[slot] = toks[-1]
        self._pos[slot] += len(toks)
        self._remaining[slot] -= len(toks)
        if (self._remaining[slot] == 0
                or self._pos[slot] >= self.max_len - 1):
            self._finish(slot)

    def _spec_step(self):
        """One speculative round: the base drafts up to ``spec_k`` tokens
        per slot into the slot's pages, each distinct active user's
        weights verify the whole window in one call, and the longest
        accepted prefix plus the target's correction/bonus token is
        committed. Greedy slots accept by argmax prefix match on the f32
        host logits, as the plain step picks; sampled slots run
        :func:`~repro_torch.serve.sampling.spec_accept`."""
        self._admit()
        if not self._active.any():
            return
        t0 = time.perf_counter()
        k = self.spec_k
        act = self._active.copy()
        d = np.where(act, np.minimum(k, self._remaining), 0).astype(np.int32)
        pos_np = np.minimum(self._pos, self.max_len - 1)
        pages = self._live_pages(pos_np + d)
        pos = self._dev(pos_np)
        d_dev = self._dev(d)
        # draft: chained base decode steps with no host sync between them;
        # slot b writes (and advances its token) only while i < d[b],
        # later steps scatter into the trash page and freeze the token.
        # Steps past max(d) would write and propose nothing: not run.
        base = self.store.materialize(None)
        tok = self._dev(self._last, torch.long)
        steps = []
        for i in range(int(d.max())):
            live = d_dev > i
            lg, self.cache = self.model.decode_step(
                base, self.cache, tok[:, None], pos + i, pages=pages,
                write_mask=live)
            tok = torch.where(live, torch.argmax(lg[:, -1, :], dim=-1), tok)
            steps.append(tok)
        drafts = torch.stack(steps).cpu().numpy()   # (max d, n_slots)
        drafts = np.concatenate(
            [drafts, np.repeat(drafts[-1:], k - len(drafts), axis=0)])
        win = np.concatenate([self._last[:, None], drafts.T], axis=1)
        win_dev = self._dev(win, torch.long)             # (n_slots, k + 1)
        wlive = np.arange(k + 1)[None, :] <= d[:, None]
        # slot -> user before any commit can finish (and clear) a slot
        slot_user = {int(i): self._req[i].user for i in np.flatnonzero(act)}
        gens = (sampling.step_keys(self.generator, self.n_slots)
                if any(not self._req[i].greedy for i in slot_user) else None)
        n_committed = 0
        for u in dict.fromkeys(slot_user.values()):     # first-seen order
            mask = np.array([slot_user.get(i, ()) == u
                             for i in range(self.n_slots)])
            lg, self.cache = self.model.verify_window(
                self.store.materialize(u), self.cache, win_dev, pos,
                pages=pages,
                write_mask=self._dev(mask[:, None] & wlive, torch.bool))
            # the pool already holds the target's K/V for every window
            # position of these slots (masked offsets wrote the trash
            # page): nothing to commit on the device
            lg = lg.float().cpu().numpy()               # (n_slots, k+1, V)
            for slot in np.flatnonzero(mask):
                req = self._req[slot]
                ds, rem = int(d[slot]), int(self._remaining[slot])
                if req.greedy:
                    tgt = lg[slot, :ds + 1].argmax(axis=1)
                    a = 0
                    while a < ds and drafts[a, slot] == tgt[a]:
                        a += 1
                    toks = tgt[:min(a + 1, rem)].tolist()
                else:
                    a, nxt = sampling.spec_accept(
                        gens[slot], drafts[:ds, slot],
                        torch.from_numpy(lg[slot, :ds + 1]),
                        req.topk or self.cfg.vocab, req.temperature)
                    toks = (drafts[:a, slot].tolist() + [nxt])[:min(a + 1,
                                                                     rem)]
                accepted = min(a, len(toks))
                self._slot_drafted[slot] += ds
                self._slot_accepted[slot] += accepted
                self.stats.spec_drafted += ds
                self.stats.spec_accepted += accepted
                n_committed += len(toks)
                self._commit(slot, toks)
        self.stats.decode_s += time.perf_counter() - t0
        self.stats.decode_tokens += n_committed
        self.stats.decode_steps += 1

    def step(self):
        """Admit whatever fits, then advance every active slot one token
        (or one speculative window when ``spec_k`` is set)."""
        if self.spec_k:
            return self._spec_step()
        self._admit()
        if not self._active.any():
            return
        t0 = time.perf_counter()
        toks = self._dev(self._last.reshape(self.n_slots, 1), torch.long)
        pos_np = np.minimum(self._pos, self.max_len - 1)
        pos = self._dev(pos_np)
        pages = self._live_pages(pos_np) if self.paged else None
        users = {self._req[i].user for i in range(self.n_slots)
                 if self._active[i]}
        merged = np.zeros((self.n_slots, self.cfg.vocab), np.float32)
        # while a chunked prefill is in flight its slot must not see
        # unmasked decode writes: its table row points at real pages
        if len(users) == 1 and self._prefill_slot is None:
            params = self.store.materialize(next(iter(users)))
            lg, self.cache = self.model.decode_step(
                params, self.cache, toks, pos, pages=pages)
            merged[:] = lg[:, -1, :].float().cpu().numpy()
        else:
            for u in users:
                mask = np.array([bool(self._active[i])
                                 and self._req[i].user == u
                                 for i in range(self.n_slots)])
                params = self.store.materialize(u)
                lg, self.cache = self.model.decode_step(
                    params, self.cache, toks, pos, pages=pages,
                    write_mask=self._dev(mask, torch.bool))
                merged[mask] = lg[:, -1, :].float().cpu().numpy()[mask]

        n_active = int(self._active.sum())
        picked: Dict[int, int] = {}
        groups: Dict[tuple, List[int]] = {}   # (topk, temp) -> slots
        for slot in np.flatnonzero(self._active):
            req = self._req[slot]
            if req.greedy:
                picked[slot] = int(merged[slot].argmax())
            else:
                groups.setdefault((req.topk or self.cfg.vocab,
                                   req.temperature), []).append(int(slot))
        if groups:          # generator split only when someone samples
            gens = sampling.step_keys(self.generator, self.n_slots)
            for (k, temp), slots in groups.items():
                toks_s = sampling.sample_topk(
                    [gens[s] for s in slots],
                    torch.from_numpy(merged[slots]), k, temp)
                picked.update(zip(slots, toks_s.tolist()))
        for slot, tok in picked.items():
            self._commit(slot, [tok])
        self.stats.decode_s += time.perf_counter() - t0
        self.stats.decode_tokens += n_active
        self.stats.decode_steps += 1

    def drain_finished(self) -> List[Completion]:
        out, self._finished = self._finished, []
        return out

    def run(self) -> List[Completion]:
        """Serve until queue and slots are empty; completions rid-sorted."""
        out: List[Completion] = []
        while (self.queue or self._active.any()
               or self._prefill_slot is not None):
            self.step()
            out.extend(self.drain_finished())
        return sorted(out, key=lambda c: c.rid)
