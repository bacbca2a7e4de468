"""Continuous-batching serve scheduler (twin of ``repro/serve/scheduler.py``).

The static :meth:`Engine.generate` pads every request of a batch to the
slowest one.  The :class:`Scheduler` instead admits variable-length
requests into a fixed pool of ``n_slots`` decode rows and runs one
pool-shaped decode step per iteration:

  admit  : while a slot is free and requests wait, bind the next request to
           a slot and prefill its prompt: in the contiguous mode through
           fixed-width [1, C] chunks (``Engine.prefill_chunk_step``) into
           the slot's rows of the pool cache; in the paged mode all of an
           iteration's admissions as ONE packed, padding-free stream
           (``Engine.packed_prefill_step``);
  decode : ONE batched decode step over all n_slots rows, each at its own
           position;
  retire : a request that hits EOS or its token budget completes at once
           and frees its slot (and pages) for the next admission.

Request lifecycle: every request ends at exactly one terminal
:data:`STATUSES` value.  ``deadline_s`` expires a request, queued or in
flight, relative to submission; :meth:`Scheduler.cancel` withdraws one by
uid; ``should_drain`` stops admissions and flushes the queue; and under the
paged ``alloc="grow"`` policy, page exhaustion preempts the latest-admitted
request: its pages are freed and it is re-queued at the head with its
generated prefix appended to the prompt, so the greedy re-prefill
reproduces the identical continuation.

Injected faults (:mod:`repro_torch.fault`) fail or preempt requests
without ever leaking a slot or page: a ``scheduler.iter`` fault skips one
iteration (counted in ``iter_faults``), a ``page_pool.alloc`` fault fails an
admission or triggers the grow policy's preemption, and a prefill or decode
step that raises :class:`~repro_torch.fault.InjectedFault` (the dispatch
ladder exhausted) fails the requests it was serving.

``stats`` and ``page_stats`` are views over the scheduler's private,
always-on metrics registry (``self.metrics``); the process-global registry
and the trace spans (``serve.iter``/``admit``/``prefill``/``decode``) record
only while obs is on.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np

from repro_torch import dispatch
from repro_torch import fault as _fault
from repro_torch.models import registry as reg
from repro_torch.obs import metrics as _om
from repro_torch.obs import trace as _ot
from repro_torch.serve.engine import Engine
from repro_torch.serve.kv_pages import PageError, PagePool, pack_prompts
from repro_torch.serve.kv_slots import SlotPool

# Global-registry mirrors (no-ops while obs is off): the process-wide view a
# trace file carries, beside each Scheduler's private always-on registry
_G_STEPS = _om.counter("serve.decode_steps")
_G_DECODE_S = _om.counter("serve.decode_s")
_G_TOKENS = _om.counter("serve.generated_tokens")
_G_COMPLETED = _om.counter("serve.completed_requests")
_G_PREEMPTIONS = _om.counter("serve.preemptions")
_G_QUEUE = _om.gauge("serve.queue_depth")
_G_ACTIVE = _om.gauge("serve.slots_active")
_G_TTFT = _om.histogram("serve.ttft_s")
_G_TPOT = _om.histogram("serve.tpot_s")
_G_LATENCY = _om.histogram("serve.latency_s")

#: Terminal request statuses (every Completion carries exactly one).
STATUSES = ("ok", "timeout", "cancelled", "failed", "preempted")


@dataclasses.dataclass
class Request:
    """One generation request: a prompt, a token budget, and an optional
    deadline (seconds after submission; expiry retires the request with
    status ``"timeout"`` whether it is queued or in flight)."""

    uid: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int = 32
    deadline_s: Optional[float] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError(f"request {self.uid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.uid}: max_new_tokens < 1")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"request {self.uid}: deadline_s <= 0")


@dataclasses.dataclass
class Completion:
    """A finished request: its generated tokens (EOS included when emitted),
    its latency breakdown and its terminal status.  A non-``ok`` completion
    carries what was generated before its terminal event (nothing for a
    request never admitted)."""

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

    def push(self, req: Request) -> None:
        self._q.append(req)

    def push_front(self, req: Request) -> None:
        """Re-enqueue at the head (a preempted request resumes first)."""
        self._q.appendleft(req)

    def pop(self) -> Request:
        return self._q.popleft()

    def peek(self) -> Request:
        """Head of the queue without removing it (paged admission checks the
        head's page cost before committing)."""
        return self._q[0]

    def take(self, pred) -> List[Request]:
        """Remove and return every queued request matching ``pred``, keeping
        the order of the rest (the deadline and cancel sweeps)."""
        taken = [r for r in self._q if pred(r)]
        if taken:
            self._q = collections.deque(r for r in self._q if not pred(r))
        return taken

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)


@dataclasses.dataclass
class _InFlight:
    """An admitted request's state.  ``admit_seq`` orders admissions (the
    preemption victim is the highest)."""

    req: Request
    t_first: float
    tokens: List[int]
    admit_seq: int = 0


class Scheduler:
    """Slot-based continuous batching on top of an :class:`Engine`.

    n_slots        : decode batch width == slot count
    max_len        : per-slot KV rows; defaults to the trace's
                     max(prompt + max_new_tokens), raised to hold the padded
                     final prefill chunk
    prefill_chunk  : the contiguous mode's chunk width C (``min(C,
                     max_len)``); it also sizes the prefill phase's dispatch
                     plan
    paged          : page the KV rows (``serve.kv_pages``): admission is
                     charged in free pages and prompts prefill as one packed
                     stream
    page_size      : KV rows per page; None lets
                     ``dispatch.choose_page_size`` pick the layout
    kv_budget_rows : physical KV rows of the page pool; defaults to
                     n_slots * max_len
    alloc          : paged allocation policy. ``"reserve"`` maps a
                     request's prompt + budget at admission (an admitted
                     request never runs out; EOS-early requests strand their
                     unused tail, counted in ``pages_stranded``).  ``"grow"``
                     maps the prompt at admission and one row ahead of each
                     decode step; exhaustion preempts the latest-admitted
                     request, restored token-identically by re-prefilling
                     its prompt and generated prefix
    max_restores   : preemptions a request survives before it retires with
                     status ``"failed"``
    """

    def __init__(self, engine: Engine, *, n_slots: int = 4,
                 max_len: Optional[int] = None, prefill_chunk: int = 16,
                 paged: bool = False, page_size: Optional[int] = None,
                 kv_budget_rows: Optional[int] = None,
                 alloc: str = "reserve", max_restores: int = 8):
        cfg = engine.cfg
        if cfg.block_pattern != "attn":
            raise ValueError(
                f"continuous batching requires an attention family "
                f"(slot-addressable KV rows); {cfg.name} has "
                f"block_pattern={cfg.block_pattern!r}. Use Engine.generate.")
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if page_size is not None and page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if alloc not in ("reserve", "grow"):
            raise ValueError(f"alloc must be 'reserve' or 'grow', got {alloc!r}")
        if alloc == "grow" and not paged:
            raise ValueError("alloc='grow' requires paged=True (the "
                             "contiguous pool has nothing to grow)")
        self.engine = engine
        self.n_slots = n_slots
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.paged = bool(paged)
        self.page_size = page_size
        self.kv_budget_rows = kv_budget_rows
        self.alloc = alloc
        self.max_restores = int(max_restores)
        self._cancelled: set = set()
        # always-on private registry backing ``stats``/``page_stats``: live
        # numbers, so a part-consumed run_iter reports what it has done
        self.metrics = _om.Registry()
        for name in ("decode_steps", "decode_s", "generated_tokens",
                     "completed_requests", "preemptions", "iter_faults",
                     "pages_stranded"):
            self.metrics.counter(name)
        for name in STATUSES:
            self.metrics.counter(f"retired_{name}")
        for name in ("requests", "total_s", "queue_depth", "slots_active",
                     "pages_active", "pages_free", "page_fragmentation",
                     "pages_peak"):
            self.metrics.gauge(name)
        for name in ("ttft_s", "tpot_s", "latency_s"):
            self.metrics.histogram(name)
        self._reset_metrics()
        # plan dispatch for the shapes this scheduler runs: [C]-row prefill
        # chunks and [n_slots]-row decode
        c_w = min(prefill_chunk, max_len) if max_len is not None else prefill_chunk
        self.dispatch_plan = dispatch.plan_params(
            engine.params, phase_hints={"prefill": c_w, "decode": n_slots},
            profile=engine.scfg.profile_dispatch)
        engine.dispatch_plan.update(self.dispatch_plan)

    # ------------------------------------------------------------------

    def _reset_metrics(self) -> None:
        self.metrics.reset()
        # the run's prefill calls and their host seconds (not in ``stats``,
        # whose key set is the JAX scheduler's)
        self.prefill_calls = 0
        self.prefill_s = 0.0

    def cancel(self, uid: int) -> None:
        """Withdraw request ``uid``: queued, it never admits; in flight, it
        retires at the next iteration boundary.  Either way its Completion
        carries status ``"cancelled"``.  Unknown uids are ignored."""
        self._cancelled.add(uid)

    @property
    def stats(self) -> Dict[str, float]:
        """Latency and throughput numbers as a view over :attr:`metrics`,
        current at any point: all zeros before the first run, and the work
        done so far while a :meth:`run_iter` generator is part-consumed.
        The percentiles are the histograms' (the upper edge of the bucket
        holding the ranked sample, as in the JAX package)."""
        c = self.metrics
        gen = c.counter("generated_tokens").value
        dec_s = c.counter("decode_s").value
        out = {
            "decode_steps": c.counter("decode_steps").value,
            "decode_s": dec_s,
            "total_s": c.gauge("total_s").value,
            "generated_tokens": gen,
            "requests": c.gauge("requests").value,
            "completed_requests": c.counter("completed_requests").value,
            "decode_tok_s": gen / dec_s if dec_s > 0 else 0.0,
            "preemptions": c.counter("preemptions").value,
            "iter_faults": c.counter("iter_faults").value,
        }
        for name in STATUSES:
            out[f"retired_{name}"] = c.counter(f"retired_{name}").value
        for h in ("ttft_s", "tpot_s", "latency_s"):
            hist = c.histogram(h)
            out[f"{h[:-2]}_p50_s"] = hist.percentile(50)
            out[f"{h[:-2]}_p99_s"] = hist.percentile(99)
        return out

    @property
    def page_stats(self) -> Dict[str, float]:
        """The page pool's occupancy (all zeros in the contiguous mode)."""
        m = self.metrics
        ps = self.page_size or 0
        peak = m.gauge("pages_peak").value
        return {
            "page_size": float(ps),
            "pages_active": m.gauge("pages_active").value,
            "pages_free": m.gauge("pages_free").value,
            "page_fragmentation": m.gauge("page_fragmentation").value,
            "pages_peak": peak,
            "kv_rows_hwm": peak * ps,
            "pages_stranded": m.counter("pages_stranded").value,
        }

    def run(self, requests: Iterable[Request],
            log_fn: Optional[Callable[[str], None]] = None,
            should_drain: Optional[Callable[[], bool]] = None,
            heartbeat: Optional[Callable[[], None]] = None) -> List[Completion]:
        """Serve every request; returns completions in finish order (see
        :meth:`run_iter`)."""
        return list(self.run_iter(requests, log_fn=log_fn,
                                  should_drain=should_drain,
                                  heartbeat=heartbeat))

    def _sizes(self, reqs: List[Request]):
        """(max_len, chunk width) of a run.  The padded final prefill chunk
        writes rows up to round_up(prompt, C), so the cache must hold that
        write: a start past S - C would clamp backwards over earlier rows."""
        needed = max(len(r.prompt) + r.max_new_tokens for r in reqs)
        c_w = self.prefill_chunk
        if self.max_len is None:
            pad_end = max(-(-len(r.prompt) // c_w) * c_w for r in reqs)
            return max(needed, pad_end), c_w
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
        return max_len, c_w

    def _page_sizes(self, max_len: int):
        """(page_size, n_pages, max_pages) of a paged run."""
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
        return ps, n_pages, max_pages

    def run_iter(self, requests: Iterable[Request],
                 log_fn: Optional[Callable[[str], None]] = None,
                 should_drain: Optional[Callable[[], bool]] = None,
                 heartbeat: Optional[Callable[[], None]] = None
                 ) -> Iterator[Completion]:
        """Generator form of :meth:`run`: yields each Completion the moment
        its iteration ends, while later requests are still decoding.  The
        only device-to-host copies are the sampled tokens.

        ``log_fn`` receives the admit/preempt/retire/drain events as text.
        ``should_drain`` is polled once per iteration; once it returns True
        admissions stop, in-flight requests decode to completion, and the
        queued ones flush with status ``"cancelled"`` (``"preempted"`` if
        they hold a restore prefix).  ``heartbeat`` is called once per
        iteration (``StepWatchdog.beat``)."""
        reqs = list(requests)
        log = log_fn or (lambda _msg: None)
        self._reset_metrics()
        m = self.metrics
        m.gauge("requests").set(len(reqs))
        if not reqs:
            return
        engine, cfg = self.engine, self.engine.cfg
        max_len, c_w = self._sizes(reqs)
        n = self.n_slots
        queue = RequestQueue(reqs)
        pool = SlotPool(n, max_len)
        pages: Optional[PagePool] = None
        ps = max_pages = 0
        if self.paged:
            ps, n_pages, max_pages = self._page_sizes(max_len)
            pages = PagePool(n_pages, ps)
            cache = reg.paged_cache_init_fn(cfg, n_pages, ps, engine.device)()
        else:
            cache = reg.cache_init_fn(cfg, n, max_len, engine.device)()
        tok_buf = np.zeros((n,), np.int32)
        inflight: Dict[int, _InFlight] = {}
        engine.reseed()
        eos = engine.scfg.eos_id
        t0 = time.perf_counter()
        c_steps = m.counter("decode_steps")
        c_decode_s = m.counter("decode_s")
        c_gen = m.counter("generated_tokens")
        c_done = m.counter("completed_requests")
        c_preempt = m.counter("preemptions")
        c_stranded = m.counter("pages_stranded")
        g_total = m.gauge("total_s")
        h_ttft, h_tpot, h_lat = (m.histogram("ttft_s"), m.histogram("tpot_s"),
                                 m.histogram("latency_s"))
        admit_seq = 0  # monotonic admission counter (preemption victim order)
        grow = pages is not None and self.alloc == "grow"

        def finish(comp: Completion) -> Completion:
            """Shared retire bookkeeping; the latency samples count ``ok``
            completions only."""
            c_done.inc()
            _G_COMPLETED.inc()
            m.counter(f"retired_{comp.status}").inc()
            self._cancelled.discard(comp.uid)  # the cancel is consumed
            if comp.status == "ok":
                tpot = (comp.t_done - comp.t_first) / max(comp.n_generated - 1, 1)
                h_ttft.observe(comp.ttft_s)
                h_tpot.observe(tpot)
                h_lat.observe(comp.latency_s)
                _G_TTFT.observe(comp.ttft_s)
                _G_TPOT.observe(tpot)
                _G_LATENCY.observe(comp.latency_s)
            _ot.instant("serve.retire", uid=comp.uid, status=comp.status,
                        generated=comp.n_generated,
                        ttft_s=round(comp.ttft_s, 6),
                        latency_s=round(comp.latency_s, 6))
            log(f"[retire] uid={comp.uid} status={comp.status} "
                f"generated={comp.n_generated} latency={comp.latency_s:.3f}s")
            return comp

        def retire(idx: int, status: str = "ok") -> Completion:
            st = inflight.pop(idx)
            if pages is not None:
                if not grow:
                    # reserve policy: release (and count) the unused tail of
                    # the reservation the moment the request ends
                    c_stranded.inc(pages.release_unused(idx))
                pages.free(idx)
            pool.free(idx)
            return finish(Completion(
                uid=st.req.uid,
                prompt_len=getattr(st.req, "_orig_prompt_len",
                                   len(st.req.prompt)),
                tokens=np.asarray(st.tokens, np.int32), t_submit=t0,
                t_first=st.t_first, t_done=time.perf_counter(),
                status=status))

        def finish_queued(req: Request, status: str) -> Completion:
            """Terminal completion of a request not in flight (never
            admitted, or preempted and not restored); it keeps the tokens
            generated before a preemption."""
            now = time.perf_counter()
            prefix = getattr(req, "_prefix", None)
            return finish(Completion(
                uid=req.uid,
                prompt_len=getattr(req, "_orig_prompt_len", len(req.prompt)),
                tokens=np.asarray([] if prefix is None else prefix, np.int32),
                t_submit=t0, t_first=getattr(req, "_t_first", now),
                t_done=now, status=status))

        def preempt(idx: int, reason: str) -> None:
            """Free the victim's slot and pages and re-queue it at the head
            with its generated prefix appended to the prompt: the greedy
            re-prefill reproduces the same continuation."""
            st = inflight.pop(idx)
            pool.free(idx)
            if pages is not None:
                pages.free(idx)
            base = st.req
            orig_len = getattr(base, "_orig_prompt_len", len(base.prompt))
            gen = np.asarray(st.tokens, np.int32)
            restored = Request(
                uid=base.uid,
                prompt=np.concatenate([base.prompt[:orig_len], gen]),
                max_new_tokens=base.max_new_tokens,
                deadline_s=base.deadline_s)
            restored._orig_prompt_len = orig_len
            restored._prefix = gen
            restored._t_first = st.t_first
            restored._restores = getattr(base, "_restores", 0) + 1
            queue.push_front(restored)
            c_preempt.inc()
            _G_PREEMPTIONS.inc()
            _ot.instant("serve.preempt", uid=base.uid, slot=idx,
                        generated=int(gen.shape[0]),
                        restores=restored._restores, reason=reason[:120])
            log(f"[preempt] uid={base.uid} slot={idx} "
                f"generated={gen.shape[0]} ({reason})")

        def set_page_gauges() -> None:
            m.gauge("pages_active").set(pages.n_mapped)
            m.gauge("pages_free").set(pages.n_free)
            m.gauge("page_fragmentation").set(pages.fragmentation())
            m.gauge("pages_peak").set(pages.peak_pages)

        it = 0
        draining = False
        while queue or pool.n_active:
            if heartbeat is not None:
                heartbeat()
            try:
                _fault.maybe_fail("scheduler.iter", it=it)
            except _fault.InjectedFault:
                # a transient hiccup: nothing was mutated yet, so the
                # iteration re-runs (the site's probe counter moved on, so a
                # deterministic schedule does not fire again)
                m.counter("iter_faults").inc()
                _ot.instant("serve.iter_fault", it=it)
                it += 1
                continue
            # completions are yielded after the iteration's span closes: a
            # span open across a yield would interleave with whatever the
            # consumer traces between iterations
            done_now: List[Completion] = []
            with _ot.span("serve.iter", it=it) as isp:
                if not draining and should_drain is not None and should_drain():
                    draining = True
                    _ot.instant("serve.drain", it=it, queued=len(queue),
                                active=pool.n_active)
                    log(f"[drain] admissions stopped; {pool.n_active} in "
                        f"flight, {len(queue)} queued")
                # -- lifecycle sweep: cancellations and deadline expiries ---
                now = time.perf_counter()

                def expired(r: Request) -> bool:
                    return r.deadline_s is not None and now - t0 > r.deadline_s

                for r in queue.take(lambda r: r.uid in self._cancelled
                                    or expired(r)):
                    status = ("cancelled" if r.uid in self._cancelled
                              else "timeout")
                    done_now.append(finish_queued(r, status))
                for idx in sorted(inflight):
                    st = inflight[idx]
                    if st.req.uid in self._cancelled:
                        done_now.append(retire(idx, "cancelled"))
                    elif expired(st.req):
                        done_now.append(retire(idx, "timeout"))

                def admit_token(req, slot, tok):
                    """The prompt's first sampled token either retires the
                    request at once or seeds its decode feed.  A restored
                    request resumes its token list and first-token time."""
                    nonlocal admit_seq
                    c_gen.inc()
                    _G_TOKENS.inc()
                    prefix = getattr(req, "_prefix", None)
                    toks = ([] if prefix is None else
                            [int(t) for t in prefix]) + [tok]
                    admit_seq += 1
                    inflight[slot.index] = _InFlight(
                        req=req,
                        t_first=getattr(req, "_t_first", None)
                        or time.perf_counter(),
                        tokens=toks, admit_seq=admit_seq)
                    log(f"[admit] uid={req.uid} slot={slot.index} "
                        f"prompt={len(req.prompt)} budget={req.max_new_tokens}")
                    if ((eos is not None and tok == eos)
                            or len(toks) >= req.max_new_tokens):
                        done_now.append(retire(slot.index))
                    else:
                        tok_buf[slot.index] = tok

                if pages is not None and not draining:
                    # -- paged admission: charged in free pages, then ONE
                    # packed padding-free prefill over every admitted prompt
                    admitted = []
                    while queue and pool.n_free:
                        head = queue.peek()
                        # grow maps the prompt only; decode claims the budget
                        need = (len(head.prompt) if grow
                                else len(head.prompt) + head.max_new_tokens)
                        if not pages.can_admit(need):
                            break  # FIFO: the head waits for pages
                        req = queue.pop()
                        slot = pool.alloc(req.uid)
                        try:
                            pages.alloc(slot.index, need, request_id=req.uid)
                        except (PageError, _fault.InjectedFault) as e:
                            # the allocator raises before it mutates (an
                            # injected fault too): the admission fails and
                            # the pools stay consistent
                            pool.free(slot.index)
                            done_now.append(finish_queued(req, "failed"))
                            log(f"[fail] uid={req.uid} admission alloc: {e}")
                            continue
                        admitted.append((req, slot))
                    if admitted:
                        packed = pack_prompts([r.prompt for r, _ in admitted],
                                              [s.index for _, s in admitted])
                        tables = pages.table_array(n, max_pages)
                        t1 = time.perf_counter()
                        try:
                            with _ot.span("serve.admit", n=len(admitted),
                                          tokens=packed.total_tokens,
                                          packed=True):
                                logits, cache = engine.packed_prefill_step(
                                    cache, packed, tables, page_size=ps)
                                toks = engine.sample(logits).tolist()
                                self.prefill_s += time.perf_counter() - t1
                                self.prefill_calls += 1
                                for (req, slot), tok in zip(admitted, toks):
                                    slot.pos = len(req.prompt)
                                    pages.advance(slot.index, len(req.prompt))
                                    admit_token(req, slot, tok)
                        except _fault.InjectedFault as e:
                            # the prefill is unservable (the dispatch ladder
                            # is exhausted): every admission of this packed
                            # batch fails
                            for req, slot in admitted:
                                if slot.index in inflight:
                                    done_now.append(
                                        retire(slot.index, "failed"))
                                else:
                                    pages.free(slot.index)
                                    pool.free(slot.index)
                                    done_now.append(
                                        finish_queued(req, "failed"))
                            log(f"[fail] packed prefill: {e}")
                elif not draining:
                    # -- contiguous admission: chunked prefill per slot -----
                    while queue and pool.n_free:
                        req = queue.pop()
                        slot = pool.alloc(req.uid)
                        t1 = time.perf_counter()
                        try:
                            with _ot.span("serve.admit", uid=req.uid,
                                          prompt=len(req.prompt),
                                          budget=req.max_new_tokens) as asp:
                                logits = self._prefill_into(
                                    cache, slot.index, req.prompt, c_w)
                                tok = int(engine.sample(logits)[0])
                                asp.set(slot=slot.index)
                        except _fault.InjectedFault as e:
                            pool.free(slot.index)
                            done_now.append(finish_queued(req, "failed"))
                            log(f"[fail] uid={req.uid} prefill: {e}")
                            continue
                        self.prefill_s += time.perf_counter() - t1
                        self.prefill_calls += -(-len(req.prompt) // c_w)
                        slot.pos = len(req.prompt)
                        admit_token(req, slot, tok)
                m.gauge("queue_depth").set(len(queue))
                m.gauge("slots_active").set(pool.n_active)
                _G_QUEUE.set(len(queue))
                _G_ACTIVE.set(pool.n_active)
                if pages is not None:
                    set_page_gauges()

                if grow and pool.n_active:
                    # -- grow on demand: map the next decode row of every
                    # live sequence; exhaustion (real or injected) preempts
                    # until the grow fits ---------------------------------
                    pos_now = pool.positions()
                    for idx in sorted(inflight):
                        while idx in inflight:
                            try:
                                pages.grow(idx, int(pos_now[idx]) + 1)
                                break
                            except (PageError, _fault.InjectedFault) as e:
                                victim = max(
                                    inflight,
                                    key=lambda i: inflight[i].admit_seq)
                                if (getattr(inflight[victim].req, "_restores",
                                            0) >= self.max_restores):
                                    done_now.append(retire(victim, "failed"))
                                else:
                                    preempt(victim, reason=str(e))
                    set_page_gauges()

                if pool.n_active:
                    # -- one pool-shaped decode step ------------------------
                    pos_vec = pool.positions()
                    t1 = time.perf_counter()
                    try:
                        with _ot.span("serve.decode", active=pool.n_active,
                                      paged=pages is not None) as dsp:
                            if pages is not None:
                                # tables are rebuilt every iteration: a
                                # retire frees pages a new admission may map,
                                # and a stale table would route an inactive
                                # slot's write into the new owner's page
                                tables = pages.table_array(n, max_pages)
                                logits, cache = engine.paged_decode_step(
                                    cache, tok_buf[:, None], pos_vec, tables,
                                    page_size=ps)
                            else:
                                logits, cache = engine.decode_step(
                                    cache, tok_buf[:, None], pos_vec)
                            toks = engine.sample(logits).tolist()
                            dt = time.perf_counter() - t1
                            dsp.set(wall_us=round(dt * 1e6, 1))
                    except _fault.InjectedFault as e:
                        # the decode step is unservable (the dispatch ladder
                        # is exhausted): every request in flight fails
                        # rather than wedging
                        for idx in sorted(inflight):
                            done_now.append(retire(idx, "failed"))
                        log(f"[fail] decode step: {e}")
                    else:
                        c_decode_s.inc(dt)
                        c_steps.inc()
                        _G_DECODE_S.inc(dt)
                        _G_STEPS.inc()
                        # -- retire finished sequences, advance the rest ----
                        for idx in sorted(inflight):
                            st = inflight[idx]
                            pool.advance(idx)  # the step wrote its fed token
                            if pages is not None:
                                pages.advance(idx)  # bounds-checked vs mapping
                            tok = toks[idx]
                            st.tokens.append(tok)
                            c_gen.inc()
                            _G_TOKENS.inc()
                            if ((eos is not None and tok == eos)
                                    or len(st.tokens) >= st.req.max_new_tokens):
                                done_now.append(retire(idx))
                            else:
                                tok_buf[idx] = tok

                if draining and not pool.n_active and queue:
                    # graceful drain: flush what will never admit (a restored
                    # prefix survives in the completion's tokens)
                    for r in queue.take(lambda _r: True):
                        status = ("preempted"
                                  if getattr(r, "_prefix", None) is not None
                                  else "cancelled")
                        done_now.append(finish_queued(r, status))
                isp.set(retired=len(done_now))
            g_total.set(time.perf_counter() - t0)
            yield from done_now
            it += 1

        g_total.set(time.perf_counter() - t0)
        if pages is not None:
            pages.check_invariants()  # end of run: no page leaked past retire
            set_page_gauges()

    # ------------------------------------------------------------------

    def _prefill_into(self, cache, slot: int, prompt: np.ndarray, c_w: int):
        """Chunked prefill of one prompt into one slot's rows of the pool.

        Streams fixed-width [1, C] chunks through ``prefill_chunk_step``
        into the slot's [L, 1, S_max, KV, D] view of the pool cache, so the
        writes land in the pool in place and no other slot's rows move.
        The final chunk is right-padded; its pad rows lie past the prompt
        and decode overwrites them before they are ever attended.  Returns
        the last real token's logits [1, 1, V].
        """
        s_len = int(len(prompt))
        sub = {k: v[:, slot:slot + 1] for k, v in cache.items()}
        logits = None
        with _ot.span("serve.prefill", slot=slot, prompt=s_len,
                      chunks=-(-s_len // c_w), chunk_w=c_w):
            for start in range(0, s_len, c_w):
                chunk = np.asarray(prompt[start:start + c_w], np.int32)[None, :]
                if chunk.shape[1] < c_w:
                    chunk = np.pad(chunk, ((0, 0), (0, c_w - chunk.shape[1])))
                logits, sub = self.engine.prefill_chunk_step(
                    sub, chunk, start, with_logits=start + c_w >= s_len)
        last = (s_len - 1) % c_w
        return logits[:, last:last + 1]


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
