"""Continuous-batching scheduler over a paged KV cache (twin of
``repro/serve/scheduler.py`` in its ``paged=True, alloc="reserve"`` mode).

The scheduler admits variable-length requests into a fixed pool of
``n_slots`` decode rows and a pool of KV pages, and runs one pool-shaped
decode step per iteration:

  admit  : while a slot is free and the head request's prompt + budget fits
           in the free pages, bind it to a slot and reserve its pages; all
           of an iteration's admissions prefill as ONE packed,
           padding-free stream (``Engine.packed_prefill_step``);
  decode : ONE batched decode step over all n_slots rows, each at its own
           position, through the page tables;
  retire : a request that hits EOS or its token budget completes at once
           and frees its slot and pages for the next admission.

The contiguous cache mode, ``alloc="grow"`` with its preemption, deadlines,
cancellation, fault injection and the observability registry wait for
later slices (ROADMAP queue 1 item 11); ``stats`` are plain numbers.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np

from repro_torch import dispatch
from repro_torch.models import registry as reg
from repro_torch.serve.engine import Engine
from repro_torch.serve.kv_pages import PagePool, pack_prompts
from repro_torch.serve.kv_slots import SlotPool

_LATER = "waits for a later slice (ROADMAP queue 1 item 11)"


@dataclasses.dataclass
class Request:
    """One generation request: a prompt and a token budget."""

    uid: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int = 32

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError(f"request {self.uid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.uid}: max_new_tokens < 1")


@dataclasses.dataclass
class Completion:
    """A finished request: its generated tokens (EOS included when emitted),
    its latency breakdown and its terminal status."""

    uid: int
    prompt_len: int
    tokens: np.ndarray  # [n_generated] int32
    t_submit: float
    t_first: float  # first token sampled (end of this request's prefill)
    t_done: float
    status: str = "ok"

    @property
    def n_generated(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def ttft_s(self) -> float:
        return self.t_first - self.t_submit

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit


class RequestQueue:
    """FIFO admission queue."""

    def __init__(self, requests: Iterable[Request] = ()):
        self._q = collections.deque(requests)

    def pop(self) -> Request:
        return self._q.popleft()

    def peek(self) -> Request:
        """Head of the queue without removing it (admission checks the
        head's page cost before committing)."""
        return self._q[0]

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)


@dataclasses.dataclass
class _InFlight:
    req: Request
    t_first: float
    tokens: List[int]


class Scheduler:
    """Slot-based continuous batching over a paged KV cache.

    n_slots        : decode batch width == slot count
    max_len        : per-request KV rows; defaults to the trace's
                     max(prompt + max_new_tokens), rounded up to whole
                     ``prefill_chunk`` rows as the JAX scheduler does
    prefill_chunk  : the JAX scheduler's chunk width; here it sizes the
                     default ``max_len`` and the prefill phase's dispatch
                     plan
    page_size      : KV rows per page; None lets
                     ``dispatch.choose_page_size`` pick the layout
    kv_budget_rows : physical KV rows of the page pool; defaults to
                     n_slots * max_len
    paged, alloc   : only ``paged=True, alloc="reserve"`` (a request's whole
                     prompt + budget is mapped at admission, so an admitted
                     request never runs out of pages)
    """

    def __init__(self, engine: Engine, *, n_slots: int = 4,
                 max_len: Optional[int] = None, prefill_chunk: int = 16,
                 paged: bool = False, page_size: Optional[int] = None,
                 kv_budget_rows: Optional[int] = None, alloc: str = "reserve"):
        if not paged:
            raise NotImplementedError(f"the contiguous cache mode {_LATER}; "
                                      "pass paged=True")
        if alloc != "reserve":
            raise NotImplementedError(f"alloc={alloc!r} {_LATER}; only "
                                      "alloc='reserve' is ported")
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if page_size is not None and page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.engine = engine
        self.n_slots = n_slots
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.page_size = page_size
        self.kv_budget_rows = kv_budget_rows
        self.stats: Dict[str, float] = {}
        # plan dispatch for the shapes this scheduler runs: [C]-row prefill
        # hints and [n_slots]-row decode
        c_w = min(prefill_chunk, max_len) if max_len is not None else prefill_chunk
        self.dispatch_plan = dispatch.plan_params(
            engine.params, phase_hints={"prefill": c_w, "decode": n_slots},
            profile=engine.scfg.profile_dispatch)
        engine.dispatch_plan.update(self.dispatch_plan)

    def run(self, requests: Iterable[Request]) -> List[Completion]:
        """Serve every request; returns completions in finish order."""
        return list(self.run_iter(requests))

    def _sizes(self, reqs: List[Request]):
        """(max_len, page_size, n_pages, max_pages) of a run."""
        needed = max(len(r.prompt) + r.max_new_tokens for r in reqs)
        c_w = self.prefill_chunk
        if self.max_len is None:
            pad_end = max(-(-len(r.prompt) // c_w) * c_w for r in reqs)
            max_len = max(needed, pad_end)
        else:
            max_len = self.max_len
            c_w = min(c_w, max_len)
            if needed > max_len:
                raise ValueError(
                    f"max_len={max_len} cannot hold the longest request "
                    f"(prompt+budget={needed})")
            pad_end = max(-(-len(r.prompt) // c_w) * c_w for r in reqs)
            if pad_end > max_len:
                raise ValueError(
                    f"prefill_chunk={c_w} pads the longest prompt to "
                    f"{pad_end} rows > max_len={max_len}; lower "
                    f"prefill_chunk or raise max_len")
        cfg = self.engine.cfg
        if self.page_size is None:
            self.page_size = dispatch.choose_page_size(
                cfg.padded_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                max_len, q_rows=self.n_slots, dtype=cfg.dtype,
                profile=self.engine.scfg.profile_dispatch,
                device=self.engine.device)
        ps = self.page_size
        budget_rows = self.kv_budget_rows or self.n_slots * max_len
        n_pages = budget_rows // ps
        max_pages = -(-max_len // ps)
        if n_pages < max_pages:
            raise ValueError(
                f"kv_budget_rows={budget_rows} ({n_pages} pages of {ps}) "
                f"cannot hold one max-length request ({max_pages} pages)")
        return max_len, ps, n_pages, max_pages

    def run_iter(self, requests: Iterable[Request]) -> Iterator[Completion]:
        """Generator form of :meth:`run`: yields each Completion the moment
        its iteration ends, while later requests are still decoding.  The
        only device-to-host copies are the sampled tokens."""
        reqs = list(requests)
        st = self.stats = {
            "requests": len(reqs), "prefill_calls": 0, "prefill_s": 0.0,
            "decode_steps": 0, "decode_s": 0.0, "generated_tokens": 0,
            "completed_requests": 0, "pages_stranded": 0, "pages_peak": 0,
            "pages_mapped": 0,
            "total_s": 0.0, "decode_tok_s": 0.0}
        if not reqs:
            return
        engine = self.engine
        max_len, ps, n_pages, max_pages = self._sizes(reqs)
        n = self.n_slots
        queue = RequestQueue(reqs)
        pool = SlotPool(n, max_len)
        pages = PagePool(n_pages, ps)
        cache = reg.paged_cache_init_fn(engine.cfg, n_pages, ps,
                                        engine.device)()
        tok_buf = np.zeros((n,), np.int32)
        inflight: Dict[int, _InFlight] = {}
        eos = engine.scfg.eos_id
        t0 = time.perf_counter()

        def retire(idx: int) -> Completion:
            fl = inflight.pop(idx)
            # reserve policy: release the unused tail of the reservation the
            # moment the request ends, and count it
            st["pages_stranded"] += pages.release_unused(idx)
            pages.free(idx)
            pool.free(idx)
            st["completed_requests"] += 1
            return Completion(
                uid=fl.req.uid, prompt_len=len(fl.req.prompt),
                tokens=np.asarray(fl.tokens, np.int32), t_submit=t0,
                t_first=fl.t_first, t_done=time.perf_counter())

        def finished(req: Request, tokens: List[int]) -> bool:
            return ((eos is not None and tokens[-1] == eos)
                    or len(tokens) >= req.max_new_tokens)

        while queue or pool.n_active:
            done_now: List[Completion] = []
            admitted = []
            while queue and pool.n_free:
                head = queue.peek()
                need = len(head.prompt) + head.max_new_tokens
                if not pages.can_admit(need):
                    break  # FIFO: the head waits for pages
                req = queue.pop()
                slot = pool.alloc(req.uid)
                pages.alloc(slot.index, need, request_id=req.uid)
                admitted.append((req, slot))
            if admitted:
                packed = pack_prompts([r.prompt for r, _ in admitted],
                                      [s.index for _, s in admitted])
                tables = pages.table_array(n, max_pages)
                t1 = time.perf_counter()
                logits, cache = engine.packed_prefill_step(
                    cache, packed, tables, page_size=ps)
                toks = engine.sample(logits).tolist()
                st["prefill_s"] += time.perf_counter() - t1
                st["prefill_calls"] += 1
                for (req, slot), tok in zip(admitted, toks):
                    slot.pos = len(req.prompt)
                    pages.advance(slot.index, len(req.prompt))
                    st["generated_tokens"] += 1
                    inflight[slot.index] = _InFlight(
                        req=req, t_first=time.perf_counter(), tokens=[tok])
                    if finished(req, [tok]):
                        done_now.append(retire(slot.index))
                    else:
                        tok_buf[slot.index] = tok
            st["pages_peak"] = pages.peak_pages

            if pool.n_active:
                # tables are rebuilt every iteration: a retire frees pages a
                # new admission may map, and a stale table would route an
                # inactive slot's write into the new owner's page
                tables = pages.table_array(n, max_pages)
                t1 = time.perf_counter()
                logits, cache = engine.paged_decode_step(
                    cache, tok_buf[:, None], pool.positions(), tables,
                    page_size=ps)
                toks = engine.sample(logits).tolist()
                st["decode_s"] += time.perf_counter() - t1
                st["decode_steps"] += 1
                for idx in sorted(inflight):
                    fl = inflight[idx]
                    pool.advance(idx)  # the step wrote the token it was fed
                    pages.advance(idx)
                    fl.tokens.append(toks[idx])
                    st["generated_tokens"] += 1
                    if finished(fl.req, fl.tokens):
                        done_now.append(retire(idx))
                    else:
                        tok_buf[idx] = toks[idx]
            st["pages_mapped"] = pages.n_mapped
            st["total_s"] = time.perf_counter() - t0
            yield from done_now

        st["total_s"] = time.perf_counter() - t0
        if st["decode_s"] > 0:
            st["decode_tok_s"] = st["generated_tokens"] / st["decode_s"]
        pages.check_invariants()  # end of run: no page leaked past retire


def latency_percentiles(completions) -> tuple:
    """(p50_s, p99_s) of request latency over a completion list
    (nearest rank; (0.0, 0.0) when empty)."""
    lat = sorted(c.latency_s for c in completions)
    if not lat:
        return 0.0, 0.0
    p50 = lat[len(lat) // 2]
    p99 = lat[min(len(lat) - 1, int(len(lat) * 0.99))]
    return p50, p99


def synthetic_trace(n_requests: int, *, seed: int = 0, vocab: int = 128,
                    prompt_lens=(4, 48), new_tokens=(4, 32)) -> List[Request]:
    """Mixed-length request trace: prompt lengths and token budgets drawn
    uniformly from the given inclusive ranges (the JAX package's draws)."""
    rng = np.random.default_rng(seed)
    out = []
    for uid in range(n_requests):
        s = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        g = int(rng.integers(new_tokens[0], new_tokens[1] + 1))
        out.append(Request(uid=uid,
                           prompt=rng.integers(0, vocab, (s,)).astype(np.int32),
                           max_new_tokens=g))
    return out
