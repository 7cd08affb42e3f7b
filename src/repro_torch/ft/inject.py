"""Deterministic fault injection behind named sites.

Every durability-critical write or read of the port passes through a
named :func:`fault_site` hook (the registry below). A seeded
:class:`FaultPlan` maps site names to fault actions, so a test, or a
subprocess crash-kill harness, can make the production code path crash
at a checkpoint commit, tear a shard file mid-write, flip a bit in an
artifact, fail transiently with ``OSError``, or stall, reproducibly:

    plan = FaultPlan({"checkpoint.commit": [Fault("crash", after=2)]})
    with faults(plan):
        build(...)          # raises InjectedCrash at the 3rd commit

Subprocesses activate a plan through the ``REPRO_FAULT_PLAN``
environment variable (the JSON of :meth:`FaultPlan.to_json`): that is
how ``repro_torch.ft.harness`` kills a real child process at a named
site (``Fault("crash", hard=True)`` -> ``os._exit(FAULT_EXIT_CODE)``,
the equivalent of ``kill -9``: no atexit, no flushing, no cleanup).
The registry, the plan's JSON and the variable's name are the
reference package's, so one plan drives either package.

With no plan installed, ``fault_site`` is a no-op costing one
attribute load and one dict probe, cheap enough for the engine's
per-superstep commit path.

The module also owns :func:`with_retries`, the bounded
retry-with-backoff wrapper the durability layers use around transient
I/O; an injected :class:`TransientIOError` is an ``OSError``, so a
fault plan exercises the retry path of the real callers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

#: exit status of a hard injected crash — distinguishable from normal
#: failures (1) and signals, so the harness can assert the child died
#: at the fault site and not somewhere else
FAULT_EXIT_CODE = 41

#: environment variable a child process reads its plan from
ENV_PLAN = "REPRO_FAULT_PLAN"

#: the instrumented sites. A FaultPlan naming anything else is a typo
#: and is rejected at construction.
KNOWN_SITES = (
    "checkpoint.write",       # CheckpointManager._write, arrays.npz on disk
    "checkpoint.commit",      # CheckpointManager._write, before the rename
    "engine.commit",          # engine.runner superstep commit, before save
    "artifact.save.shard",    # CHLIndex.save, one shard file on disk
    "artifact.save.commit",   # CHLIndex.save, before the staged swap
    "artifact.load.shard",    # CHLIndex.load, before parsing a shard
    "quant.encode.shard",     # CompressedStore._encode, one shard
    "quant.decode.shard",     # CompressedStore.from_encoded_shards
    "repair.merge",           # dynamic.repair, before the store swap
    "spill.query",            # SpillStore.gather_rows, before the read
    "serve.answer",           # QueryService._launch, before the kernel
)

#: fault kinds a plan may schedule
FAULT_KINDS = ("crash", "torn", "bitflip", "io", "latency")


class InjectedCrash(BaseException):
    """A soft injected crash (``hard=False``). Derives from
    ``BaseException`` so no production ``except Exception`` / retry
    wrapper can swallow it — exactly like a real kill."""

    def __init__(self, site: str):
        super().__init__(f"injected crash at fault site {site!r}")
        self.site = site


class TransientIOError(OSError):
    """An injected transient I/O failure (an ``OSError``, so the
    production retry wrappers see exactly what a flaky disk throws)."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault at a site.

    ``after``: hits of the site that pass through before the fault
    triggers (0 = the first hit). ``count`` (io only): how many
    consecutive hits raise before the site heals — the knob retry
    tests turn. ``hard`` (crash only): ``os._exit`` instead of raising
    :class:`InjectedCrash`.
    """

    kind: str
    after: int = 0
    count: int = 1
    keep_fraction: float = 0.5       # torn: fraction of bytes kept
    flips: int = 1                   # bitflip: bits to flip
    delay_s: float = 0.0             # latency: injected stall
    hard: bool = False               # crash: os._exit vs InjectedCrash

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one "
                             f"of {FAULT_KINDS}")
        if not 0.0 <= self.keep_fraction < 1.0:
            raise ValueError("keep_fraction must be in [0, 1)")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class FaultPlan:
    """A seeded schedule of faults keyed by site name.

    Deterministic twice over: per-site hit counters make *when* a
    fault fires reproducible, and the per-site rng streams (derived
    from ``seed`` + a stable hash of the site name, independent of
    call order across sites) make *what* it does to the bytes
    reproducible.
    """

    def __init__(self, sites: Dict[str, Sequence[Fault]], *,
                 seed: int = 0):
        for name in sites:
            if name not in KNOWN_SITES:
                raise ValueError(
                    f"unknown fault site {name!r}; instrumented sites: "
                    f"{KNOWN_SITES}")
        self.sites: Dict[str, List[Fault]] = {
            name: list(fs) for name, fs in sites.items()}
        self.seed = int(seed)
        self.hits: Dict[str, int] = {name: 0 for name in self.sites}
        self.fired: List[Tuple[str, str]] = []       # (site, kind) log

    # ------------------------------------------------------ plumbing

    def _rng(self, site: str) -> np.random.Generator:
        return np.random.default_rng(
            [self.seed, zlib.crc32(site.encode())])

    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "sites": {name: [f.to_dict() for f in fs]
                      for name, fs in self.sites.items()}})

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        spec = json.loads(text)
        return cls({name: [Fault(**f) for f in fs]
                    for name, fs in spec.get("sites", {}).items()},
                   seed=spec.get("seed", 0))

    # -------------------------------------------------------- firing

    def fire(self, site: str, path: Optional[str]) -> None:
        faults = self.sites.get(site)
        if not faults:
            return
        self.hits[site] += 1
        hit = self.hits[site]
        for f in faults:
            if f.kind == "io":
                if not f.after < hit <= f.after + f.count:
                    continue
            elif hit != f.after + 1:
                continue
            self.fired.append((site, f.kind))
            self._trigger(site, f, path)

    def _trigger(self, site: str, f: Fault, path: Optional[str]) -> None:
        if f.kind == "crash":
            if f.hard:
                # a real kill: no unwinding, no atexit, no flushing
                os._exit(FAULT_EXIT_CODE)
            raise InjectedCrash(site)
        if f.kind == "latency":
            time.sleep(f.delay_s)
            return
        if f.kind == "io":
            raise TransientIOError(
                f"injected transient I/O failure at {site!r}"
                + (f" ({path})" if path else ""))
        # file-mutating kinds need the file the site just touched
        if path is None or not os.path.exists(path):
            raise ValueError(
                f"fault {f.kind!r} at site {site!r} needs an on-disk "
                f"path (got {path!r})")
        if f.kind == "torn":
            torn_write(path, f.keep_fraction)
        elif f.kind == "bitflip":
            flip_bits(path, self._rng(site), flips=f.flips)


def torn_write(path: str, keep_fraction: float) -> int:
    """Truncate ``path`` to a prefix — the on-disk shape of a crash
    between ``write()`` and durability. Returns bytes kept."""
    size = os.path.getsize(path)
    keep = max(1, int(size * keep_fraction)) if size else 0
    with open(path, "r+b") as fh:
        fh.truncate(keep)
    return keep


def flip_bits(path: str, rng: np.random.Generator, flips: int = 1
              ) -> List[int]:
    """Flip ``flips`` seeded bit positions in ``path`` (silent media
    corruption); returns the flipped byte offsets."""
    size = os.path.getsize(path)
    if size == 0:
        return []
    offsets = sorted(int(o) for o in
                     rng.integers(0, size, size=flips))
    with open(path, "r+b") as fh:
        for off in offsets:
            fh.seek(off)
            byte = fh.read(1)[0]
            fh.seek(off)
            fh.write(bytes([byte ^ (1 << int(rng.integers(0, 8)))]))
    return offsets


# --------------------------------------------------------------------
# installation: one process-wide active plan
# --------------------------------------------------------------------

_active: Optional[FaultPlan] = None
_env_loaded = False


def install(plan: Optional[FaultPlan]) -> None:
    """Install ``plan`` as the process-wide active fault plan
    (``None`` uninstalls)."""
    global _active
    _active = plan


@contextlib.contextmanager
def faults(plan: FaultPlan):
    """Scoped installation: ``with faults(plan): ...``"""
    prev = _active
    install(plan)
    try:
        yield plan
    finally:
        install(prev)


def _plan() -> Optional[FaultPlan]:
    global _env_loaded, _active
    if _active is not None:
        return _active
    if not _env_loaded:
        _env_loaded = True
        text = os.environ.get(ENV_PLAN)
        if text:
            _active = FaultPlan.from_json(text)
    return _active


def fault_site(name: str, path: Optional[str] = None) -> None:
    """The hook production code calls at a named durability-critical
    point. ``path``, when given, is the file the site just wrote (or
    is about to read) — the target of torn/bitflip faults. A no-op
    unless a plan is installed (or ``REPRO_FAULT_PLAN`` is set)."""
    plan = _plan()
    if plan is not None:
        plan.fire(name, path)


# --------------------------------------------------------------------
# bounded retry with backoff — the transient-I/O answer
# --------------------------------------------------------------------

def with_retries(fn: Callable[[], object], *, retries: int = 3,
                 base_delay_s: float = 0.01, max_delay_s: float = 1.0,
                 retry_on: tuple = (OSError,),
                 describe: str = "") -> object:
    """Call ``fn``; on a ``retry_on`` exception retry up to
    ``retries`` times with exponential backoff (capped at
    ``max_delay_s``). The last failure propagates. An
    :class:`InjectedCrash` is a ``BaseException`` and is never
    retried — a crash is a crash."""
    delay = base_delay_s
    for attempt in range(retries + 1):
        try:
            return fn()
        except retry_on:
            if attempt >= retries:
                raise
            time.sleep(delay)
            delay = min(delay * 2, max_delay_s)
    raise AssertionError("unreachable")  # pragma: no cover
