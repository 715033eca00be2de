"""Structured span tracing for the HAIL runtime, exported as Chrome
trace-event JSON (Perfetto-loadable).

Two clocks, two trace processes:

* **pid 1 "hail (measured wall)"** — real ``time.perf_counter`` sections:
  upload phases, flush lifecycle (result-cache probe, batching, plan,
  per-split dispatch, verify, cache fill, ticket finalize), adaptive
  builds, demotions, quarantine/repair instants, scrubber ticks.
* **pid 2 "cluster (simulated)"** — the deterministic simulated timeline:
  ``run_schedule`` task runs become per-node tracks, ``ServerFrontend``
  queries become per-tenant slices from arrival to modeled completion,
  and flow arrows (``s``/``t``/``f`` events keyed by ticket id) connect a
  query's slice to every scheduler task its answer depended on.

Tracing is OFF by default and ZERO-COST when off: every module-level hook
(`span`, ``instant``, ``complete_wall``, …) reads one global and returns a
shared no-op when no tracer is installed — no allocation (the hooks live
on the host side of every kernel launch).  Install
with ``tracer = trace.install()``, export with ``tracer.export(path)``,
remove with ``trace.uninstall()``.

``validate_chrome_trace`` checks the exported object against the parts of
the Chrome trace-event contract Perfetto actually enforces: known phases,
numeric non-negative ``ts``, non-negative ``dur`` on ``X`` events, and
per-(pid, tid) ``B``/``E`` discipline (LIFO name matching, monotone
timestamps, no unclosed spans) — CI validates every uploaded trace with it.
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import Optional

PID_WALL = 1     # measured perf_counter sections
PID_SIM = 2      # simulated scheduler/frontend timeline

_VALID_PHASES = frozenset("BEXiIMstfCbne")


class Tracer:
    """Event buffer + clock anchor for one tracing run."""

    def __init__(self):
        self.t0 = time.perf_counter()      # epoch for the measured clock
        self.events: list[dict] = []
        self._tids: dict[tuple[int, str], int] = {}
        self._flow_seen: set[int] = set()
        for pid, name in ((PID_WALL, "hail (measured wall)"),
                          (PID_SIM, "cluster (simulated)")):
            self.events.append({"ph": "M", "pid": pid, "tid": 0, "ts": 0,
                                "name": "process_name",
                                "args": {"name": name}})

    # -- tracks -------------------------------------------------------------

    def _tid(self, pid: int, track: str) -> int:
        key = (pid, track)
        tid = self._tids.get(key)
        if tid is None:
            tid = sum(1 for k in self._tids if k[0] == pid) + 1
            self._tids[key] = tid
            self.events.append({"ph": "M", "pid": pid, "tid": tid, "ts": 0,
                                "name": "thread_name",
                                "args": {"name": track}})
        return tid

    def now_us(self) -> float:
        return (time.perf_counter() - self.t0) * 1e6

    # -- measured-wall events -----------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, *, cat: str = "hail", track: str = "main",
             args: Optional[dict] = None):
        """B/E span on the measured clock around a ``with`` body."""
        tid = self._tid(PID_WALL, track)
        ev = {"ph": "B", "pid": PID_WALL, "tid": tid, "name": name,
              "cat": cat, "ts": self.now_us()}
        if args:
            ev["args"] = dict(args)
        self.events.append(ev)
        try:
            yield self
        finally:
            self.events.append({"ph": "E", "pid": PID_WALL, "tid": tid,
                                "name": name, "cat": cat,
                                "ts": self.now_us()})

    def instant(self, name: str, *, cat: str = "hail", track: str = "main",
                args: Optional[dict] = None):
        ev = {"ph": "i", "pid": PID_WALL, "tid": self._tid(PID_WALL, track),
              "name": name, "cat": cat, "ts": self.now_us(), "s": "t"}
        if args:
            ev["args"] = dict(args)
        self.events.append(ev)

    def complete_wall(self, name: str, start_pc: float, dur_s: float, *,
                      cat: str = "hail", track: str = "main",
                      args: Optional[dict] = None):
        """X slice from a raw ``perf_counter`` stamp + duration — for
        async-dispatched work whose wall is only known after its barrier
        (per-split reads record their dispatch stamp, then emit here)."""
        ev = {"ph": "X", "pid": PID_WALL, "tid": self._tid(PID_WALL, track),
              "name": name, "cat": cat,
              "ts": max(0.0, (start_pc - self.t0) * 1e6),
              "dur": max(0.0, dur_s) * 1e6}
        if args:
            ev["args"] = dict(args)
        self.events.append(ev)

    # -- simulated-clock events ---------------------------------------------

    def complete_sim(self, name: str, start_s: float, dur_s: float, *,
                     cat: str = "sim", track: str = "timeline",
                     args: Optional[dict] = None):
        ev = {"ph": "X", "pid": PID_SIM, "tid": self._tid(PID_SIM, track),
              "name": name, "cat": cat, "ts": max(0.0, start_s) * 1e6,
              "dur": max(0.0, dur_s) * 1e6}
        if args:
            ev["args"] = dict(args)
        self.events.append(ev)

    def flow(self, ph: str, flow_id: int, ts_s: float, *, track: str,
             name: str = "query", cat: str = "sim"):
        """One flow-arrow endpoint (ph in s/t/f) on the simulated clock."""
        ev = {"ph": ph, "pid": PID_SIM, "tid": self._tid(PID_SIM, track),
              "name": name, "cat": cat, "id": int(flow_id),
              "ts": max(0.0, ts_s) * 1e6}
        if ph == "f":
            ev["bp"] = "e"
        elif ph == "s":
            self._flow_seen.add(int(flow_id))
        self.events.append(ev)

    def add_schedule(self, sched, tasks, *, base_s: float = 0.0,
                     label: str = "split"):
        """Render one ``run_schedule`` result onto the simulated timeline:
        every TaskRun becomes an X slice on its node's track, and each
        query id a task carries becomes a flow step (``t``) there — with
        the final carrying run emitting the flow end (``f``), so Perfetto
        draws an arrow chain from the query's arrival slice (the frontend
        emits the ``s`` start) through every split it waited on."""
        by_id = {t.task_id: t for t in tasks}
        completion = getattr(sched, "query_completion_s", {}) or {}
        for run in sorted(sched.runs, key=lambda r: r.start_s):
            task = by_id.get(run.task_id)
            track = f"node {run.node}"
            args = {"task": run.task_id, "speculative": run.speculative}
            qids = tuple(task.query_ids) if task is not None else ()
            if task is not None:
                args.update(n_queries=task.n_queries,
                            read_s=task.duration_s,
                            build_s=task.index_build_s,
                            rekey_s=task.rekey_s,
                            queries=list(qids))
            self.complete_sim(label, base_s + run.start_s,
                              run.end_s - run.start_s, track=track,
                              args=args)
            for qid in qids:
                ends_here = abs(completion.get(qid, -1.0) - run.end_s) < 1e-12
                if qid not in self._flow_seen:
                    self._flow_seen.add(qid)
                    self.flow("s", qid, base_s + run.start_s, track=track)
                if ends_here:
                    self.flow("f", qid, base_s + run.end_s, track=track)
                else:
                    self.flow("t", qid, base_s + run.start_s, track=track)

    # -- export -------------------------------------------------------------

    def export(self, path: Optional[str] = None) -> dict:
        trace = {"traceEvents": list(self.events),
                 "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(trace, f)
        return trace


# ---------------------------------------------------------------------------
# module-level hooks: one global read when tracing is off
# ---------------------------------------------------------------------------

_TRACER: Optional[Tracer] = None


class _NullSpan:
    """Shared no-op context manager — the entire cost of a disabled span."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


def install(tracer: Optional[Tracer] = None) -> Tracer:
    """Install (and return) the process-global tracer."""
    global _TRACER
    _TRACER = tracer if tracer is not None else Tracer()
    return _TRACER


def uninstall() -> Optional[Tracer]:
    """Remove the global tracer; returns it (export still works)."""
    global _TRACER
    t, _TRACER = _TRACER, None
    return t


def current() -> Optional[Tracer]:
    return _TRACER


def enabled() -> bool:
    return _TRACER is not None


def span(name: str, **kw):
    t = _TRACER
    return _NULL if t is None else t.span(name, **kw)


def instant(name: str, **kw):
    t = _TRACER
    if t is not None:
        t.instant(name, **kw)


def complete_wall(name: str, start_pc: float, dur_s: float, **kw):
    t = _TRACER
    if t is not None:
        t.complete_wall(name, start_pc, dur_s, **kw)


def complete_sim(name: str, start_s: float, dur_s: float, **kw):
    t = _TRACER
    if t is not None:
        t.complete_sim(name, start_s, dur_s, **kw)


def add_schedule(sched, tasks, **kw):
    t = _TRACER
    if t is not None:
        t.add_schedule(sched, tasks, **kw)


def flow(ph: str, flow_id: int, ts_s: float, **kw):
    t = _TRACER
    if t is not None:
        t.flow(ph, flow_id, ts_s, **kw)


# ---------------------------------------------------------------------------
# Chrome trace-event validation (the CI gate for exported traces)
# ---------------------------------------------------------------------------


def validate_chrome_trace(trace) -> list[str]:
    """Return a list of contract violations (empty == valid).

    Checks: top-level shape, known phases, numeric non-negative ``ts``,
    non-negative ``dur`` on X events, and per-(pid, tid) B/E discipline —
    every E matches the innermost open B by name, timestamps never run
    backwards within a track's B/E stream, and no span is left open.
    """
    errors: list[str] = []
    if isinstance(trace, dict):
        events = trace.get("traceEvents")
        if not isinstance(events, list):
            return ["traceEvents missing or not a list"]
    elif isinstance(trace, list):
        events = trace
    else:
        return [f"trace must be dict or list, got {type(trace).__name__}"]

    stacks: dict[tuple, list[str]] = {}
    last_ts: dict[tuple, float] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _VALID_PHASES:
            errors.append(f"event {i}: unknown phase {ph!r}")
            continue
        if ph == "M":
            continue                       # metadata: no timing contract
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"event {i} ({ev.get('name')!r}): bad ts {ts!r}")
            continue
        if ph == "X":
            dur = ev.get("dur", 0)
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"event {i} ({ev.get('name')!r}): "
                              f"bad dur {dur!r}")
        if ph in ("B", "E"):
            key = (ev.get("pid"), ev.get("tid"))
            if ts < last_ts.get(key, 0.0) - 1e-9:
                errors.append(f"event {i} ({ev.get('name')!r}): ts not "
                              f"monotone on track {key}")
            last_ts[key] = max(last_ts.get(key, 0.0), float(ts))
            stack = stacks.setdefault(key, [])
            if ph == "B":
                stack.append(ev.get("name"))
            else:
                if not stack:
                    errors.append(f"event {i}: E {ev.get('name')!r} "
                                  f"without open B on track {key}")
                elif stack[-1] != ev.get("name"):
                    errors.append(f"event {i}: E {ev.get('name')!r} does "
                                  f"not match open B {stack[-1]!r}")
                    stack.pop()
                else:
                    stack.pop()
    for key, stack in stacks.items():
        if stack:
            errors.append(f"track {key}: unclosed spans {stack}")
    return errors
