"""Deterministic fault injection; the port's copy of
lightgbmv1_tpu/utils/faults.py.

Each recovery path of the server and the trainer has an injection point,
so that tests exercise it.  A fault plan is a seeded list of
:class:`FaultSpec` that fires on the Nth matching event (then ``count``
consecutive ones), never on the clock, so a scenario replays exactly.

* **Free when inactive.**  ``fire`` reads one module global and returns.
* **Deterministic.**  Plans count events; ``seed`` drives only the byte
  choices of ``corrupt`` mode.
* **Across processes.**  ``LGBMV1_FAULTS`` (a JSON list of spec dicts)
  arms a plan at import, so a CLI run in a subprocess can be killed
  mid-snapshot (``kill`` is a real ``os._exit``).

The sites in the port (grep ``faults.fire``):

========================  =====================================================
kind                      site / effect
========================  =====================================================
``h2d``                   models/predict.py ``BatchPredictor.predict_leaf`` /
                          ``predict_raw`` — raise before a chunk goes to the
                          device (a transient device error)
``file_write``            utils/fileio.py atomic writer — ``truncate`` (torn
                          file), ``corrupt`` (flipped bytes), ``kill`` (die
                          after the temporary write, before the rename)
``grad_poison``           models/gbdt.py ``GBDT._gradients`` — NaN on the
                          gradient and hessian of every 13th row at iteration
                          ``payload`` (read once at build with ``peek``, so it
                          counts no event), before ``finite_guard=clamp``
``dispatch``              serve/server.py — ``raise`` (a failed device batch),
                          ``stall`` (wedge for ``stall_s``), ``exit_thread``
                          (the dispatcher thread dies)
``replica_wedge``         serve/server.py — inside the dispatcher with the
                          batch in flight, site = the server's name
                          (``server`` when it has none); ``stall`` wedges the
                          batch (the watchdog's case)
``publish_warm``          serve/registry.py — fail a publish mid-warm, before
                          the atomic swap
``snapshot``              cli.py — after the Nth snapshot / checkpoint write
                          (``kill`` crashes the training process there)
``rpc_drop``              serve/router.py — per routed attempt, site = the
                          replica's name; ``raise`` drops the link to that
                          replica before dispatch (the router retries
                          elsewhere)
``rpc_delay``             serve/router.py — the same site; ``stall`` is a slow
                          link (drives hedging)
========================  =====================================================

The JAX package's ``peer_dead`` (elastic training, ROADMAP queue 1 item 14)
has no site in the port: arming a plan that holds it (``activate``, and so
``inject`` and ``LGBMV1_FAULTS``) raises, naming that item.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .log import log_warning


class FaultInjected(RuntimeError):
    """An injected fault fired in ``raise`` mode.  Deliberately a plain
    RuntimeError subclass: recovery code must treat it like any real
    transient error (retry, shed, roll back), never special-case it."""


class ThreadKilled(BaseException):
    """``exit_thread`` mode: kills the *current worker thread* (the serve
    dispatcher), not the process.  A BaseException so ordinary
    ``except Exception`` recovery paths cannot swallow the death — the
    watchdog must notice the corpse instead."""


@dataclass
class FaultSpec:
    """One scripted fault: fire on the ``at``-th matching event (1-based)
    and the following ``count - 1`` events."""

    kind: str                 # h2d | file_write | grad_poison | dispatch | ...
    mode: str = "raise"       # raise | truncate | corrupt | kill | stall |
                              # exit_thread | nan
    at: int = 1               # 1-based index of the first firing event
    count: int = 1            # consecutive events that fire from `at`
    match: str = ""           # substring the site must contain ("" = any)
    stall_s: float = 0.0      # mode=stall: how long to wedge
    payload: int = 0          # kind-specific (grad_poison: iteration index)

    def to_dict(self) -> Dict[str, object]:
        return {k: getattr(self, k) for k in
                ("kind", "mode", "at", "count", "match", "stall_s",
                 "payload")}


class FaultPlan:
    """A seeded list of :class:`FaultSpec` with per-spec event counters.
    Thread-safe: serve-path hooks fire from dispatcher/watchdog threads."""

    def __init__(self, specs: List[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._counts: Dict[int, int] = {}
        self.fired: List[Tuple[str, str, str]] = []   # (kind, site, mode)

    # ------------------------------------------------------------------
    def on_event(self, kind: str, site: str = "") -> Optional[FaultSpec]:
        """Count one event; return the spec that fires on it, if any."""
        hit = None
        with self._lock:
            for i, sp in enumerate(self.specs):
                if sp.kind != kind or (sp.match and sp.match not in site):
                    continue
                n = self._counts.get(i, 0) + 1
                self._counts[i] = n
                if sp.at <= n < sp.at + sp.count and hit is None:
                    hit = sp
                    self.fired.append((kind, site, sp.mode))
        return hit

    def peek(self, kind: str) -> Optional[FaultSpec]:
        """First spec of a kind WITHOUT counting an event — for faults
        read once at build (grad_poison)."""
        for sp in self.specs:
            if sp.kind == kind:
                return sp
        return None

    def corrupt_bytes(self, data: bytes, event_index: int = 0) -> bytes:
        """Seeded byte flips in the middle third of the payload."""
        import numpy as np

        if not data:
            return data
        rng = np.random.RandomState((self.seed * 1_000_003 + event_index)
                                    & 0x7FFFFFFF)
        buf = bytearray(data)
        lo, hi = len(buf) // 3, max(2 * len(buf) // 3, len(buf) // 3 + 1)
        for _ in range(max(8, (hi - lo) // 64)):
            i = int(rng.randint(lo, hi))
            buf[i] ^= 0xFF
        return bytes(buf)


# ---------------------------------------------------------------------------
# module-global active plan
# ---------------------------------------------------------------------------

_ACTIVE: Optional[FaultPlan] = None


def active() -> bool:
    return _ACTIVE is not None


def current_plan() -> Optional[FaultPlan]:
    return _ACTIVE


# kinds of the JAX package whose site the port lacks
_UNPORTED_KINDS = ("peer_dead",)


def activate(plan: Optional[FaultPlan]) -> None:
    """Arm ``plan`` (None disarms); a plan holding a kind with no site in
    the port raises ``NotImplementedError`` naming its ROADMAP item."""
    global _ACTIVE
    for sp in (plan.specs if plan is not None else ()):
        if sp.kind in _UNPORTED_KINDS:
            from ..config import PARALLEL, not_ported

            raise not_ported(f"a {sp.kind} fault plan (the elastic "
                             "workers' site)", PARALLEL)
    _ACTIVE = plan


def deactivate() -> None:
    activate(None)


class inject:
    """Context manager arming a plan for the enclosed block::

        with faults.inject(FaultSpec("h2d", mode="raise", at=2)):
            ...
    """

    def __init__(self, *specs: FaultSpec, seed: int = 0):
        self.plan = FaultPlan(list(specs), seed=seed)

    def __enter__(self) -> FaultPlan:
        activate(self.plan)
        return self.plan

    def __exit__(self, *exc) -> None:
        deactivate()


def plan_from_env(env_var: str = "LGBMV1_FAULTS") -> Optional[FaultPlan]:
    """Arm a plan from a JSON spec list in the environment — the bridge
    that lets a chaos scenario inject faults into a *subprocess* CLI run
    (the only honest way to test a SIGKILL-grade crash)."""
    raw = os.environ.get(env_var, "")
    if not raw:
        return None
    try:
        items = json.loads(raw)
        seed = 0
        specs = []
        for it in items:
            if "seed" in it and len(it) == 1:
                seed = int(it["seed"])
                continue
            specs.append(FaultSpec(**it))
        return FaultPlan(specs, seed=seed)
    except (ValueError, TypeError) as e:
        log_warning(f"faults: unparseable {env_var} ignored ({e})")
        return None


# arm automatically for subprocess scenarios; a no-op when the var is unset
if os.environ.get("LGBMV1_FAULTS"):
    activate(plan_from_env())


# ---------------------------------------------------------------------------
# hooks
# ---------------------------------------------------------------------------


def fire(kind: str, site: str = "") -> Optional[FaultSpec]:
    """The generic injection hook.  Handles the process/thread-level modes
    itself (``raise`` / ``stall`` / ``kill`` / ``exit_thread``); returns
    the spec for caller-interpreted modes (``truncate`` / ``corrupt`` /
    ``nan``) and ``None`` when nothing fires."""
    plan = _ACTIVE
    if plan is None:
        return None
    sp = plan.on_event(kind, site)
    if sp is None:
        return None
    # every firing injection is a first-class structured event — the
    # forensic bundle of the crash it induces must name its own cause
    try:
        from ..obs import events

        events.publish("fault.injected",
                       f"{kind} fault ({sp.mode}) at {site or '<any>'}",
                       severity="warning", fault_kind=kind, site=site,
                       mode=sp.mode)
    except Exception:   # noqa: BLE001 — injection must stay injection
        pass
    if sp.mode == "raise":
        raise FaultInjected(f"injected {kind} fault at {site or '<any>'}")
    if sp.mode == "stall":
        log_warning(f"faults: stalling {kind}/{site} for {sp.stall_s}s")
        time.sleep(sp.stall_s)
        return sp
    if sp.mode == "kill":
        # the honest crash: no atexit, no finally blocks, no flush —
        # but a real panicking process gets its black box out first,
        # so the armed flight recorder dumps before the lights go out
        try:
            from ..obs import dump

            dump.dump("fault_kill", error=f"{kind} kill at {site}")
        except Exception:   # noqa: BLE001
            pass
        os._exit(137)
    if sp.mode == "exit_thread":
        raise ThreadKilled(f"injected {kind} thread death at {site}")
    return sp



def grad_poison_iteration() -> Optional[int]:
    """Iteration index of an armed ``grad_poison`` fault, or None.  Read
    once at trainer build: the poison fires at that iteration only."""
    plan = _ACTIVE
    if plan is None:
        return None
    sp = plan.peek("grad_poison")
    return int(sp.payload) if sp is not None else None
