"""Guard plane: a resilient execution runtime around the batched sweep
plane.

The stack simulates chip/link faults end-to-end (the chaos plane); this
module lets the *harness itself* survive a SIGKILL mid-campaign, a
wedged device call, or a NaN escaping the sweep kernel. It gives
campaign entry points (``fleet.sweep_fleet`` / ``fleet.sweep_chaos``)
the same retry / checkpoint / failover discipline the NPUs get:

* **Crash-consistent campaign checkpointing** —
  :class:`CampaignCheckpoint` publishes epoch-granular JSON snapshots
  with the write-to-tmp + ``os.replace`` + write-``manifest``-last +
  ``wait()`` discipline (:func:`atomic_write_json`). A
  :class:`RunManifest` (seeds, knob-grid digest, device, severity
  ladder, scenario digest) pins
  the checkpoint to one campaign; resuming with anything else is a
  named ``ValueError``, never silent garbage. Because every stochastic
  input in the fleet plane is recomputed from explicit seeded
  generators with a fixed draw order (the ``perturb.py`` /
  ``faults.py`` contract), a resumed campaign replays the remaining
  epochs bit-for-bit: the final report is **bit-identical** to an
  uninterrupted run (JSON round-trips float64 exactly via shortest
  repr).

* **Device failover ladder with retry/backoff** —
  :class:`GuardedRunner` executes each ``evaluate_batch`` under a
  deadline watchdog (worker thread + timed join; a wedged attempt is
  abandoned, not waited on). On timeout / launch failure / device
  loss it retries with exponential backoff + deterministic seeded
  jitter, then escalates down ``backend.failover_rungs``. A mesh puts
  the rung ``"mesh"`` (the sharded sweep) first. Below it, the card's
  ladder (``"cuda"``: the hand-written kernels) has no rung: once its
  attempts are used up the call raises :class:`GuardError`, so a
  campaign asked of the card is never finished on the host. This is
  where the port departs from the JAX package, whose ladder ends on its
  numpy engine. A ``"cpu"`` ladder falls from ``"cpu"`` (the same
  ``_sweep_kernel`` on the kernels' plain versions) to ``"numpy"`` (the
  independent numpy batched engine, ``policies.evaluate_batch_numpy``).
  Every retry and step down lands in a structured :class:`GuardReport`
  event with a named reason — mirroring the fleet plane's own
  degradation ladder, but for the harness.

* **Numerical quarantine** — every result cube is finite-checked. If
  any cell is NaN/Inf, the poisoned cells are quarantined and
  re-evaluated per-cell on the numpy oracle, and every surviving cell
  must match a full oracle re-run to ``oracle_tol`` (≤1e-9) — silent
  corruption becomes a loud, attributable :class:`GuardError` or a
  recorded quarantine event, never a wrong BET frontier.

Determinism contract: the guard machinery never changes *what* is
computed, only *where* and *how many times*. Backoff jitter draws come
from ``np.random.default_rng((seed, _GUARD_PLANE, step))`` — their own
child stream, so retries can never shift an arrival or fault draw.

On a mesh (the hazard the JAX package never had: its mesh has one
controller, here every rank runs its own guard):

* **The ranks agree on every attempt.** If one rank retried or stepped
  down alone, the others would wait in a collective forever. So after
  each attempt on the mesh rung, outside the watchdog's thread, every
  rank joins one exchange of its outcome (ok, error or timeout, its
  reason, the collectives it issued) over a gloo group of the mesh's
  ranks with a timeout of its own; a failing rank joins it too. All
  ranks then return, retry or step down together, and log the same
  events, the first failing rank's reason in each.
* **A rung out of step is left at once.** Where some rank's attempt
  timed out, or the ranks issued different numbers of collectives, the
  mesh's groups hold a collective that not every rank joined, and a
  retry on them would pair one rank's sums with another's. The ladder
  then steps down without retrying there. ``parallel.dist.sweep_mesh``'s
  ``timeout_s`` makes such a stranded collective raise rather than
  wait.
* **Checkpoints are written by the mesh's first rank only**
  (:class:`CampaignCheckpoint` ``writer=``); every rank reads them on
  resume, so all resume from the same epoch.

On the card:

* **The deadline covers device work, not the build.** The kernels are
  compiled by ``nvcc`` at first use (``kernels/_build.py``), which on a
  cold tree takes a minute or more. Before each attempt on a CUDA rung,
  the default runner loads the power-plane library and touches the
  device in the calling thread, outside the watchdog, so a cold build
  can never be mistaken for a wedged call. A failure there (no
  ``nvcc``, a library that does not load, no card) is no transient
  fault: it raises :class:`GuardError` at once, without a retry. Every
  attempt returns only once its cubes are host numpy
  (``BatchResult`` comes back through ``TorchBackend.to_numpy``, which
  waits for the card), so the deadline does cover the kernels.
* **An abandoned attempt keeps running.** A Python thread cannot be
  killed: a worker abandoned on a timeout runs its ``evaluate_batch`` to
  the end, and the kernels it already queued stay on the card. A retry
  on the same device queues behind them (the time of the wedged call is
  paid again, inside the next attempt's deadline), and the wrappers'
  launch counters go on counting them. What is computed does not
  change: every call allocates its own tensors, and the caches it fills
  (``StackedTrace._derived``) hold the same values whichever thread
  fills them.
"""
from __future__ import annotations

import dataclasses
import datetime
import functools
import hashlib
import json
import math
import os
import queue
import signal
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np

__all__ = [
    "GuardError", "GuardPolicy", "GuardReport", "GuardedRunner",
    "RunManifest", "CampaignCheckpoint", "atomic_write_json",
    "digest_of",
]

# child-stream tag for guard-plane jitter draws (perturb.py uses small
# plane indices for trace jitter; this one is reserved for the guard)
_GUARD_PLANE = 9


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(msg)


class GuardError(RuntimeError):
    """The guard exhausted its ladder or found unexplainable results."""


# --------------------------------------------------------------------------
# policy + report data model
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class GuardPolicy:
    """How hard the harness fights before giving up.

    ``timeout_s``       — per-attempt deadline on one ``evaluate_batch``
                          (watchdog; a wedged device call counts as a
                          failure, not a hang).
    ``max_retries``     — extra attempts per ladder rung after the
                          first (0 = one attempt per rung).
    ``backoff_base_s``  — first retry delay; attempt ``i`` waits
                          ``backoff_base_s * backoff_factor**i *
                          (1 + backoff_jitter * u)`` with ``u`` drawn
                          from the seeded guard stream (deterministic).
    ``oracle_tol``      — max relative error a surviving cell may show
                          vs the numpy oracle during quarantine.
    ``checkpoint_every``— epochs between published snapshots (the
                          final epoch always publishes).
    """

    timeout_s: float = 30.0
    max_retries: int = 2
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    backoff_jitter: float = 0.1
    oracle_tol: float = 1e-9
    checkpoint_every: int = 1

    def __post_init__(self):
        _check(isinstance(self.timeout_s, (int, float))
               and not isinstance(self.timeout_s, bool)
               and math.isfinite(self.timeout_s) and self.timeout_s > 0,
               f"timeout_s must be finite and > 0, got "
               f"{self.timeout_s!r}")
        _check(isinstance(self.max_retries, (int, np.integer))
               and not isinstance(self.max_retries, bool)
               and self.max_retries >= 0,
               f"max_retries must be an int >= 0, got "
               f"{self.max_retries!r}")
        _check(isinstance(self.backoff_base_s, (int, float))
               and math.isfinite(self.backoff_base_s)
               and self.backoff_base_s > 0,
               f"backoff_base_s must be finite and > 0, got "
               f"{self.backoff_base_s!r}")
        _check(isinstance(self.backoff_factor, (int, float))
               and math.isfinite(self.backoff_factor)
               and self.backoff_factor >= 1.0,
               f"backoff_factor must be finite and >= 1, got "
               f"{self.backoff_factor!r}")
        _check(isinstance(self.backoff_jitter, (int, float))
               and 0.0 <= self.backoff_jitter < 1.0,
               f"backoff_jitter must be in [0, 1), got "
               f"{self.backoff_jitter!r}")
        _check(isinstance(self.oracle_tol, (int, float))
               and math.isfinite(self.oracle_tol)
               and self.oracle_tol > 0,
               f"oracle_tol must be finite and > 0, got "
               f"{self.oracle_tol!r}")
        _check(isinstance(self.checkpoint_every, (int, np.integer))
               and not isinstance(self.checkpoint_every, bool)
               and self.checkpoint_every >= 1,
               f"checkpoint_every must be an int >= 1, got "
               f"{self.checkpoint_every!r}")

    def backoff_delay(self, attempt: int,
                      rng: np.random.Generator) -> float:
        """Deterministic delay before retry ``attempt`` (0-based),
        consuming exactly one uniform from ``rng``."""
        u = float(rng.random())
        return float(self.backoff_base_s
                     * self.backoff_factor ** attempt
                     * (1.0 + self.backoff_jitter * u))


@dataclass
class GuardReport:
    """Structured log of every escalation the guard took.

    One dict per event, each with a ``kind`` (``retry`` / ``failover``
    / ``quarantine`` / ``oracle_recheck``) and a named human-readable
    ``reason`` — the harness-side mirror of the fleet plane's
    degradation-ladder bookkeeping.
    """

    events: list[dict] = field(default_factory=list)

    def add(self, kind: str, reason: str, **extra) -> dict:
        ev = {"kind": kind, "reason": reason, **extra}
        self.events.append(ev)
        return ev

    def count(self, kind: str) -> int:
        return sum(1 for e in self.events if e["kind"] == kind)

    @property
    def retries(self) -> int:
        return self.count("retry")

    @property
    def failovers(self) -> int:
        return self.count("failover")

    @property
    def quarantined_cells(self) -> int:
        return self.count("quarantine")

    def to_dict(self) -> dict:
        return {"events": list(self.events),
                "retries": self.retries,
                "failovers": self.failovers,
                "quarantined_cells": self.quarantined_cells}

    @classmethod
    def from_dict(cls, d: dict) -> "GuardReport":
        return cls(events=[dict(e) for e in d.get("events", [])])


# --------------------------------------------------------------------------
# canonical digests + the run manifest
# --------------------------------------------------------------------------

def _canon(obj):
    """json.dumps fallback: canonicalize dataclasses / numpy values so
    ``digest_of`` is stable across processes."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {type(obj).__name__: dataclasses.asdict(obj)}
    if isinstance(obj, np.ndarray):
        return [str(obj.dtype), obj.tolist()]
    if isinstance(obj, (np.integer, np.floating, np.bool_)):
        return obj.item()
    return repr(obj)


def digest_of(obj: Any) -> str:
    """Short stable content digest (sha256 prefix) of any mix of
    dataclasses / tuples / numpy arrays / scalars."""
    blob = json.dumps(obj, sort_keys=True, default=_canon)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


@dataclass(frozen=True)
class RunManifest:
    """Identity of one checkpointed campaign.

    A checkpoint directory belongs to exactly one (scenario, knob
    grid, device, severity ladder) tuple; ``check`` raises a named
    ``ValueError`` on the first differing field, so a resume can never
    silently splice two different campaigns together.
    """

    kind: str                       # "fleet" | "chaos"
    seed: int
    n_epochs: int
    backend: str                    # the device string: "cuda", "cpu", ...
    knob_digest: str
    scenario_digest: str
    severity_levels: tuple = ()     # the scenario's severity ladder
    fault_severities: tuple = ()    # chaos campaigns: the fault ladder
    policies: tuple = ()

    def __post_init__(self):
        _check(isinstance(self.kind, str) and bool(self.kind),
               f"kind must be a non-empty str, got {self.kind!r}")
        _check(isinstance(self.seed, (int, np.integer))
               and not isinstance(self.seed, bool),
               f"seed must be an int, got {self.seed!r}")
        _check(isinstance(self.n_epochs, (int, np.integer))
               and not isinstance(self.n_epochs, bool)
               and self.n_epochs >= 1,
               f"n_epochs must be an int >= 1, got {self.n_epochs!r}")
        _check(isinstance(self.backend, str) and bool(self.backend),
               f"backend must be a non-empty str, got {self.backend!r}")
        _check(isinstance(self.knob_digest, str) and bool(self.knob_digest),
               f"knob_digest must be a non-empty str, got "
               f"{self.knob_digest!r}")
        _check(isinstance(self.scenario_digest, str)
               and bool(self.scenario_digest),
               f"scenario_digest must be a non-empty str, got "
               f"{self.scenario_digest!r}")
        object.__setattr__(self, "severity_levels",
                           tuple(float(s) for s in self.severity_levels))
        object.__setattr__(self, "fault_severities",
                           tuple(float(s) for s in self.fault_severities))
        object.__setattr__(self, "policies", tuple(self.policies))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "RunManifest":
        return cls(**{f.name: d[f.name]
                      for f in dataclasses.fields(cls)})

    def check(self, other: "RunManifest") -> None:
        """Raise a named ValueError on the first differing field."""
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            if a != b:
                raise ValueError(
                    f"checkpoint manifest mismatch on {f.name}: "
                    f"checkpoint has {b!r}, this campaign has {a!r} — "
                    f"refusing to resume a different campaign")


# --------------------------------------------------------------------------
# atomic JSON publish
# --------------------------------------------------------------------------

def atomic_write_json(path: str, obj: Any) -> None:
    """Write ``obj`` as JSON to ``path`` via write-to-tmp +
    ``os.replace`` — a crash mid-write can never corrupt ``path``."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


# --------------------------------------------------------------------------
# kill hook: self-fault-injection for the harness
# --------------------------------------------------------------------------
# REPRO_GUARD_KILL="boundary:<epoch>" SIGKILLs the process right after
# snapshot <epoch> is published; "mid:<epoch>" kills while epoch
# <epoch> is being processed (before its snapshot exists). This is the
# chaos plane turned on the harness itself — the kill–resume tests use
# it to prove the bit-identical resume invariant against real SIGKILLs.
# The variable is read once, at import: a child process sets it before
# it imports this module.

_KILL_SPEC = os.environ.get("REPRO_GUARD_KILL", "")


def _kill_armed(phase: str, step: int) -> bool:
    if not _KILL_SPEC:
        return False
    p, _, s = _KILL_SPEC.partition(":")
    return p == phase and s == str(step)


def maybe_kill(phase: str, step: int) -> None:
    """SIGKILL the current process if REPRO_GUARD_KILL targets this
    (phase, step). No-op (one string compare) otherwise."""
    if _kill_armed(phase, step):
        os.kill(os.getpid(), signal.SIGKILL)


# --------------------------------------------------------------------------
# campaign checkpoints
# --------------------------------------------------------------------------

class CampaignCheckpoint:
    """Epoch-granular atomic snapshots for a campaign run.

    Layout inside ``directory``::

        manifest.json   — RunManifest, written (atomically) first
        epoch_<e>.json  — loop state after epoch e completed
        final.json      — the full report once the run finished

    ``save_epoch`` snapshots synchronously (shallow list copies — the
    fleet loop only ever *appends* records) and serializes + publishes
    on a background thread, joined by ``wait()`` before the next save
    and at close. Retention keeps the newest ``keep``
    epoch snapshots, deleting older ones only after a successful
    publish. With ``writer=False`` (every rank of a mesh but its first)
    the checkpoint only reads: it checks an existing manifest, writes
    nothing and still honors an armed kill.
    """

    def __init__(self, directory, manifest: RunManifest, *,
                 keep: int = 2, writer: bool = True):
        _check(isinstance(directory, (str, os.PathLike)),
               f"checkpoint must be a directory path (str or "
               f"os.PathLike), got {type(directory).__name__}")
        _check(isinstance(manifest, RunManifest),
               f"manifest must be a RunManifest, got {type(manifest)}")
        _check(isinstance(keep, (int, np.integer)) and keep >= 1,
               f"keep must be an int >= 1, got {keep!r}")
        self.dir = os.fspath(directory)
        self.manifest = manifest
        self.keep = int(keep)
        self.writer = bool(writer)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        if self.writer:
            os.makedirs(self.dir, exist_ok=True)
        mpath = os.path.join(self.dir, "manifest.json")
        if os.path.exists(mpath):
            with open(mpath) as f:
                manifest.check(RunManifest.from_dict(json.load(f)))
        elif self.writer:
            atomic_write_json(mpath, manifest.to_dict())

    # ---------------------------------------------------------- save
    def save_epoch(self, epoch: int, state: dict) -> None:
        """Publish the post-epoch snapshot (async), then honor an armed
        boundary kill (after the publish is fully on disk)."""
        self.wait()
        if not self.writer:
            maybe_kill("boundary", epoch)
            return
        path = os.path.join(self.dir, f"epoch_{epoch}.json")

        def _write():
            try:
                atomic_write_json(path, state)
                self._gc()
            except BaseException as e:   # surfaced at next wait()
                self._error = e

        if _kill_armed("boundary", epoch):
            _write()
            self._raise_pending()
            maybe_kill("boundary", epoch)
        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def save_final(self, report: dict) -> None:
        self.wait()
        if self.writer:
            atomic_write_json(os.path.join(self.dir, "final.json"), report)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    close = wait

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async campaign snapshot failed") from err

    def _gc(self) -> None:
        for e in self.epochs()[:-self.keep]:
            try:
                os.remove(os.path.join(self.dir, f"epoch_{e}.json"))
            except OSError:
                pass

    # ------------------------------------------------------- restore
    def epochs(self) -> list[int]:
        out = []
        if not os.path.isdir(self.dir):
            return out
        for name in os.listdir(self.dir):
            if name.startswith("epoch_") and name.endswith(".json"):
                try:
                    out.append(int(name[len("epoch_"):-len(".json")]))
                except ValueError:
                    pass
        return sorted(out)

    def load_epoch(self) -> Optional[dict]:
        """Latest restorable epoch snapshot, or None for a fresh run."""
        self.wait()
        for e in reversed(self.epochs()):
            path = os.path.join(self.dir, f"epoch_{e}.json")
            try:
                with open(path) as f:
                    return json.load(f)
            except (OSError, json.JSONDecodeError):   # pragma: no cover
                continue   # publish is atomic; tolerate stray files
        return None

    def load_final(self) -> Optional[dict]:
        self.wait()
        path = os.path.join(self.dir, "final.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)


# --------------------------------------------------------------------------
# the guarded runner: watchdog + retry/backoff + failover + quarantine
# --------------------------------------------------------------------------

class _Timeout(Exception):
    pass


class _Watchdog:
    """Deadline execution on ONE persistent daemon worker.

    A fresh thread per call costs GIL handoff and cold scheduling for
    every epoch's ``evaluate_batch``; a single long-lived worker does
    not. On a deadline miss the wedged worker is abandoned with its
    queue (daemon — its late result lands in a dead box, and it cannot
    block interpreter exit) and a replacement is spawned, so the caller
    escalates instead of hanging on a wedged call. A worker retires when
    its watchdog is closed or collected, or, if abandoned, once its
    wedged call returns: no idle thread outlives its runner.
    """

    def __init__(self):
        self._spawn()

    def _spawn(self) -> None:
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._t = threading.Thread(target=self._loop, args=(self._q,),
                                   daemon=True)
        # the worker's stop item, queued at close or collection (never
        # holding a reference to the watchdog itself)
        self._retire = weakref.finalize(self, self._q.put, None)
        self._t.start()

    @staticmethod
    def _loop(q: "queue.SimpleQueue") -> None:
        while True:
            item = q.get()
            if item is None:   # retired replacement worker
                return
            fn, box, done = item
            try:
                box["value"] = fn()
            except BaseException as e:
                box["error"] = e
            finally:
                done.set()
                # hold nothing of the call while idle: its closure keeps
                # the runner, hence this watchdog, alive
                item = fn = box = done = None

    def run(self, fn: Callable[[], Any], timeout_s: float):
        box: dict = {}
        done = threading.Event()
        self._q.put((fn, box, done))
        if not done.wait(timeout_s):
            self._retire()  # the wedged worker stops once its call returns
            self._spawn()   # abandon the wedged worker + its queue
            raise _Timeout(f"deadline {timeout_s:g}s exceeded")
        if "error" in box:
            raise box["error"]
        return box["value"]

    def close(self) -> None:
        self._retire()


def _warm_device(dev) -> None:
    """Build (on a cold tree) and load the power-plane library of kernels
    K1 / K2, and create ``dev``'s context."""
    import torch
    from repro_torch.kernels import _build
    _build.load("power_plane")
    torch.zeros(1, device=dev)


def _result_fields(res) -> list[tuple[str, np.ndarray]]:
    """Every (name, cube) pair of a BatchResult, for finite checks and
    oracle comparison."""
    out = [("runtime_s", res.runtime_s)]
    for group in ("static_j", "dynamic_j", "wake_events", "gated_s",
                  "setpm_by"):
        for c, arr in getattr(res, group).items():
            out.append((f"{group}[{c}]", arr))
    return out


def _rel_err(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-300)


def tree_max_rel(ref, got, rtol: float, path: str = "") -> float:
    """Two nested dicts / lists / tuples of plain values (a report's
    ``to_dict()`` form) held to one rule: the same keys and lengths,
    every ``str``, ``bool``, ``int`` and ``None`` equal, every float
    within ``rtol`` in ``|a - b| / max(1e-30, |a|, |b|)``. Returns the
    worst relative deviation; raises ``GuardError`` at the first path
    that breaks the rule."""
    if isinstance(ref, dict):
        if not (isinstance(got, dict) and set(ref) == set(got)):
            raise GuardError(f"{path}: keys differ")
        return max((tree_max_rel(ref[k], got[k], rtol, f"{path}.{k}")
                    for k in ref), default=0.0)
    if isinstance(ref, (list, tuple)):
        if not (isinstance(got, (list, tuple)) and len(ref) == len(got)):
            raise GuardError(f"{path}: lengths differ")
        return max((tree_max_rel(a, b, rtol, f"{path}[{i}]")
                    for i, (a, b) in enumerate(zip(ref, got))),
                   default=0.0)
    if isinstance(ref, float) and not isinstance(got, bool):
        if not isinstance(got, (float, int)):
            raise GuardError(f"{path}: {got!r} vs {ref!r}")
        err = abs(ref - got) / max(1e-30, abs(ref), abs(got))
        if not err <= rtol:
            raise GuardError(f"{path}: {got!r} vs {ref!r} (rel "
                             f"{err:.3e} > {rtol:g})")
        return err
    if not (type(got) is type(ref) and got == ref):
        raise GuardError(f"{path}: {got!r} vs {ref!r}")
    return 0.0


def cube_max_rel(ref, got, rtol: float) -> float:
    """Two ``BatchResult`` cubes, field by field and component by
    component: the same shapes, finite, within ``rtol`` in ``|a - b| /
    max(1e-30, |a|, |b|)``. Returns the worst relative deviation; raises
    ``GuardError`` naming the first field that breaks the rule."""
    worst = 0.0
    got_fields = dict(_result_fields(got))
    for name, a in _result_fields(ref):
        b = got_fields.get(name)
        if b is None or a.shape != b.shape:
            raise GuardError(f"{name}: missing or of another shape")
        if not (np.isfinite(a).all() and np.isfinite(b).all()):
            raise GuardError(f"{name}: non-finite values")
        err = float((np.abs(a - b) / np.maximum(
            1e-30, np.maximum(np.abs(a), np.abs(b)))).max(initial=0.0))
        if not err <= rtol:
            raise GuardError(f"{name}: rel {err:.3e} > {rtol:g}")
        worst = max(worst, err)
    return worst


class GuardedRunner:
    """Executes ``evaluate_batch`` calls under the guard policy.

    ``rungs`` defaults to ``backend.failover_rungs(device, mesh)``
    (``None``: the session's); callers may inject a custom ladder plus a
    stub ``runner`` (``runner(rung, workloads, npus, policies, knobs)``,
    the rung's name first, and ``mesh=`` as well on a rung that carries
    one) and a stub ``oracle`` (``oracle(workloads, npus, policies,
    knobs)``). The default runner runs a mesh rung on ``device``.
    ``report`` accumulates every escalation across calls.
    """

    def __init__(self, policy: Optional[GuardPolicy] = None, *,
                 device=None, mesh=None, seed: int = 0,
                 rungs: Optional[Sequence[tuple]] = None,
                 runner: Optional[Callable] = None,
                 oracle: Optional[Callable] = None):
        if policy is None:
            policy = GuardPolicy()
        _check(isinstance(policy, GuardPolicy),
               f"policy must be a GuardPolicy, got {type(policy)}")
        self.policy = policy
        self.seed = int(seed)
        self.report = GuardReport()
        from repro_torch.core.backend import failover_rungs, resolve_device
        self.device = str(resolve_device(device))
        if rungs is None:
            rungs = failover_rungs(device, mesh)
        _check(len(rungs) >= 1, "rungs must be non-empty")
        self.rungs = tuple((str(n), m) for n, m in rungs)
        # only the default runner builds kernels at first use; a rung is
        # prepared once, at its first attempt
        self._prepare_rungs = runner is None
        self._prepared: set = set()
        self._runner = runner if runner is not None \
            else functools.partial(self._default_runner, device=self.device)
        self._oracle = oracle if oracle is not None \
            else self._default_oracle
        self._watchdog: Optional[_Watchdog] = None
        self._agree_groups: dict = {}

    @staticmethod
    def _default_runner(rung: str, workloads, npus, policies, knobs, *,
                        mesh=None, device=None):
        """``rung`` ``"numpy"``: the numpy batched engine; a rung with a
        ``mesh`` the sharded ``evaluate_batch`` on ``device``; any other
        rung is a device string for ``evaluate_batch``."""
        from repro_torch.core.policies import (evaluate_batch,
                                               evaluate_batch_numpy)
        if rung == "numpy":
            return evaluate_batch_numpy(workloads, npus, policies, knobs)
        if mesh is not None:
            return evaluate_batch(workloads, npus, policies, knobs,
                                  device=device, mesh=mesh)
        return evaluate_batch(workloads, npus, policies, knobs,
                              device=rung)

    @staticmethod
    def _default_oracle(workloads, npus, policies, knobs):
        from repro_torch.core.policies import evaluate_batch_numpy
        return evaluate_batch_numpy(workloads, npus, policies, knobs)

    def _prepare(self, rung: str, step: int) -> None:
        """What a CUDA rung needs before its first deadline starts: the
        power-plane library (built by ``nvcc`` on a cold tree) and the
        device's context. A failure here is no transient fault, so it
        raises ``GuardError`` at once; a rung is marked prepared only
        once this succeeded."""
        if rung in self._prepared:
            return
        if rung != "numpy":
            import torch
            dev = torch.device(self.device if rung == "mesh" else rung)
            if dev.type == "cuda":
                try:
                    _warm_device(dev)
                except Exception as e:
                    raise GuardError(
                        f"rung {rung!r} could not be prepared at step "
                        f"{step} (error: {type(e).__name__}: {e})") from e
        self._prepared.add(rung)

    def _agree(self, mesh, outcome: str, reason: str, issued: int) \
            -> tuple[str, str, bool]:
        """One exchange of every mesh rank's attempt outcome (``"ok"``,
        ``"error"``, ``"timeout"``), reason and collectives issued
        (``-1``: unknown, the attempt is still running). Returns the
        outcome all ranks act on, its reason (the first failing rank's,
        named) and whether the ranks' collectives are in step."""
        import torch.distributed as dist
        hit = self._agree_groups.get(id(mesh))
        if hit is None or hit[0] is not mesh:
            ranks = sorted(int(r) for r in mesh.mesh.flatten().tolist())
            wait = datetime.timedelta(
                seconds=2.0 * self.policy.timeout_s + 60.0)
            group = dist.new_group(ranks, backend="gloo", timeout=wait,
                                   use_local_synchronization=True)
            hit = self._agree_groups[id(mesh)] = (mesh, group, ranks)
        _, group, ranks = hit
        views: list = [None] * len(ranks)
        dist.all_gather_object(views, (outcome, reason, int(issued)),
                               group=group)
        in_step = all(v[0] != "timeout" for v in views) \
            and len({v[2] for v in views}) == 1
        for rank, (o, why, _) in zip(ranks, views):
            if o != "ok":
                return o, f"rank {rank}: {why}", in_step
        return "ok", "", in_step

    # -------------------------------------------------------- execute
    def evaluate_batch(self, workloads, npus, policies, knobs, *,
                       step: int = 0):
        """One guarded batched-sweep call: ladder x (1 + max_retries)
        attempts, each under the deadline watchdog, then finite-check /
        quarantine. ``step`` tags events (0 = calibration, e + 1 =
        epoch e in the fleet plane) and keys the jitter stream."""
        pol = self.policy
        if self._watchdog is None:
            self._watchdog = _Watchdog()
        rng = None   # lazily seeded: only failures draw jitter
        last_reason = ""
        from repro_torch.core.backend import TorchBackend
        for ri, (rung, mesh) in enumerate(self.rungs):
            kw = {} if mesh is None else {"mesh": mesh}
            for attempt in range(pol.max_retries + 1):
                if self._prepare_rungs:
                    self._prepare(rung, step)
                issued = TorchBackend.collectives
                try:
                    res = self._watchdog.run(
                        lambda: self._runner(rung, workloads, npus,
                                             policies, knobs, **kw),
                        pol.timeout_s)
                except _Timeout as e:
                    outcome, last_reason = "timeout", f"timeout: {e}"
                except Exception as e:
                    outcome = "error"
                    last_reason = (f"error: {type(e).__name__}: {e}")
                else:
                    outcome = "ok"
                in_step = True
                if mesh is not None:
                    issued = -1 if outcome == "timeout" \
                        else TorchBackend.collectives - issued
                    outcome, why, in_step = self._agree(
                        mesh, outcome, last_reason, issued)
                    if outcome != "ok":
                        last_reason = why
                if outcome == "ok":
                    return self._quarantine(res, workloads, npus,
                                            policies, knobs,
                                            rung=rung, step=step)
                if not in_step:
                    last_reason += ("; the ranks' collectives are out of "
                                    "step, so the rung is not retried")
                    break
                if attempt < pol.max_retries:
                    if rng is None:
                        rng = np.random.default_rng(
                            (self.seed, _GUARD_PLANE, int(step)))
                    delay = pol.backoff_delay(attempt, rng)
                    self.report.add(
                        "retry", last_reason, step=int(step),
                        rung=rung, attempt=attempt,
                        delay_s=delay)
                    time.sleep(delay)
            if ri + 1 < len(self.rungs):
                self.report.add(
                    "failover",
                    f"rung {rung!r} exhausted after "
                    f"{attempt + 1} attempts ({last_reason}); "
                    f"downgrading to {self.rungs[ri + 1][0]!r}",
                    step=int(step), rung=rung,
                    next_rung=self.rungs[ri + 1][0])
        raise GuardError(
            f"all {len(self.rungs)} failover rungs exhausted at step "
            f"{step} ({last_reason})")

    # ----------------------------------------------------- quarantine
    def _quarantine(self, res, workloads, npus, policies, knobs, *,
                    rung: str, step: int):
        fields = _result_fields(res)
        bad = np.zeros(res.shape, bool)
        for _, arr in fields:
            bad |= ~np.isfinite(arr)
        if not bad.any():
            return res

        tol = self.policy.oracle_tol
        # names for attributable events
        wl_names = [getattr(w, "name", str(w)) for w in workloads]
        cells = list(zip(*np.nonzero(bad)))
        for (w, a, p, k) in cells:
            poisoned = [name for name, arr in fields
                        if not np.isfinite(arr[w, a, p, k])]
            self.report.add(
                "quarantine",
                f"non-finite {','.join(poisoned)} from rung {rung!r} "
                f"at cell (workload={wl_names[w]}, npu={a}, "
                f"policy={policies[p]}, knob={k}); re-evaluated on "
                f"the numpy oracle",
                step=int(step), rung=rung,
                cell=[int(w), int(a), int(p), int(k)],
                fields=poisoned)

        # full oracle cube: survivors must be explainable ≤ oracle_tol
        ora = self._oracle(workloads, npus, policies, knobs)
        ora_fields = dict(_result_fields(ora))
        worst = 0.0
        patched = {}
        for name, arr in fields:
            oarr = ora_fields[name]
            if not np.isfinite(oarr).all():
                w, a, p, k = [int(i[0]) for i in
                              np.nonzero(~np.isfinite(oarr))]
                raise GuardError(
                    f"numpy oracle itself is non-finite in {name} at "
                    f"cell (workload={wl_names[w]}, npu={a}, policy="
                    f"{policies[p]}, knob={k}) — the model, not the "
                    f"device, is poisoned")
            ok = ~bad
            err = _rel_err(arr, oarr)[ok]
            if err.size and float(err.max()) > tol:
                worst_ix = np.zeros(res.shape, bool)
                worst_ix[ok] = _rel_err(arr, oarr)[ok] == err.max()
                w, a, p, k = [int(i[0]) for i in np.nonzero(worst_ix)]
                raise GuardError(
                    f"surviving cell disagrees with the numpy oracle "
                    f"beyond {tol:g}: {name} at (workload="
                    f"{wl_names[w]}, npu={a}, policy={policies[p]}, "
                    f"knob={k}) rel err {float(err.max()):.3e} — rung "
                    f"{rung!r} results are not trustworthy")
            worst = max(worst, float(err.max()) if err.size else 0.0)
            patched[name] = np.where(bad, oarr, arr)

        # per-cell oracle re-evaluation of the poisoned cells: each is
        # recomputed in isolation and must agree with the full oracle
        # cube (stacking must not change a cell's value)
        for (w, a, p, k) in cells:
            cell = self._oracle([workloads[w]], (npus[a],),
                                (policies[p],), (knobs[k],))
            for name, arr in _result_fields(cell):
                ref = float(ora_fields[name][w, a, p, k])
                err = float(_rel_err(np.asarray(arr[0, 0, 0, 0]),
                                     np.asarray(ref)))
                if err > tol:
                    raise GuardError(
                        f"per-cell oracle re-evaluation disagrees with "
                        f"the batched oracle: {name} at (workload="
                        f"{wl_names[w]}, npu={a}, policy={policies[p]},"
                        f" knob={k}) rel err {err:.3e}")

        self.report.add(
            "oracle_recheck",
            f"quarantined {len(cells)} cell(s) from rung {rung!r}; "
            f"survivors match the numpy oracle to "
            f"{max(worst, 0.0):.3e} (tol {tol:g})",
            step=int(step), rung=rung, n_quarantined=len(cells),
            max_survivor_rel_err=worst)

        def split(prefix):
            return {c: patched[f"{prefix}[{c}]"]
                    for c in getattr(res, prefix)}

        return dataclasses.replace(
            res, runtime_s=patched["runtime_s"],
            static_j=split("static_j"), dynamic_j=split("dynamic_j"),
            wake_events=split("wake_events"), gated_s=split("gated_s"),
            setpm_by=split("setpm_by"))
