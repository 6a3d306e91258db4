"""Deterministic fault injection for the host control plane.

A copy of the JAX package's ``parallel/chaos.py`` (it imports no JAX):
the same spec and seed make the same decisions over the same command
sequence in both packages, since both draw from ``random.Random(seed)``.

Reference analog: the OSDI'14 paper's fault-tolerance claims (vector-clock
idempotent retransmission, scheduler-driven recovery) are only credible if
every failure mode can be *produced on demand*. The reference exercised them
by killing processes under script/local.sh; this module goes further: a
seeded :class:`FaultPlan` armed on any ``RpcServer`` (and therefore any
``ShardServer`` or ``Coordinator``) perturbs the framed wire protocol itself
— dropping requests before they apply, severing connections after they
apply but before the reply lands, delaying frames, and duplicating frames —
so the retry/reconnect/dedup machinery in parallel/control.py is testable on
CPU with no real pod and no real packet loss.

Fault actions (decided per received frame, by command):

``drop``
    Discard the request *before* the handler runs and close the connection
    (the request was lost on the wire). Exercises pure resend.
``disconnect``
    Run the handler (side effects happen, the reply is cached by the dedup
    layer) then close the connection *without* replying (the reply was lost).
    Exercises reconnect + reply-cache dedup — the dangerous half of
    at-least-once delivery for non-idempotent commands.
``delay``
    Sleep ``delay_s`` before handling. Exercises stragglers, SSP waits and
    heartbeat-timeout tuning.
``duplicate``
    Deliver the frame to the dispatch layer twice (second reply discarded) —
    a duplicated frame in flight. Without dedup this double-applies.

Plans are deterministic given their seed: every probabilistic decision comes
from one ``random.Random(seed)`` stream (frame arrival order across
connection threads is still OS-scheduled, but a plan replayed over the same
frame sequence makes the same calls). ``shutdown`` frames are never
perturbed — chaos on the teardown handshake only tests the harness.

Arming: pass ``fault_plan=`` to ``RpcServer``/``ShardServer``/
``Coordinator``, or set the environment variables ``PS_FAULT_PLAN`` (spec
string) and ``PS_FAULT_SEED`` before the server process starts — the env
path is how ``launch_local`` and the multi-host test children arm every
node they spawn without new plumbing.

Spec DSL (``;``-separated rules; first token is the action, the rest
``key=value``)::

    drop,prob=0.05;delay,prob=0.1,delay_s=0.02;disconnect,cmd=push,every=7

Rule keys: ``cmd`` (exact command match, default ``*`` = any),
``prob`` (per-frame firing probability), ``every`` (fire on every Nth
matching frame instead of randomly), ``delay_s`` (for ``delay``),
``max`` (total firing budget for the rule; -1 = unbounded).
A JSON list of rule objects with the same keys (plus ``action``) is also
accepted (spec starting with ``[``).
"""

from __future__ import annotations

import json
import os
import random
import threading
from dataclasses import dataclass

from parameter_server_tpu_torch.utils.metrics import wire_counters

ACTIONS = ("drop", "disconnect", "delay", "duplicate")

# commands chaos must never touch: perturbing the shutdown handshake only
# wedges the harness (a server that already stopped cannot be re-asked)
_EXEMPT_CMDS = frozenset({"shutdown"})

PLAN_ENV = "PS_FAULT_PLAN"
SEED_ENV = "PS_FAULT_SEED"


@dataclass
class FaultRule:
    """One perturbation rule; ``prob`` and ``every`` are alternatives
    (``every`` wins when > 0 — deterministic cadence beats dice)."""

    action: str
    cmd: str = "*"  # exact command match; "*" matches any
    prob: float = 0.0
    every: int = 0  # fire on every Nth matching frame (0 = use prob)
    delay_s: float = 0.02
    max_fires: int = -1  # firing budget; -1 unbounded
    seen: int = 0  # matching frames observed (mutated under plan lock)
    fires: int = 0

    def __post_init__(self) -> None:
        if self.action not in ACTIONS:
            raise ValueError(
                f"unknown fault action {self.action!r}; known: {ACTIONS}"
            )
        if self.every == 0 and not (0.0 <= self.prob <= 1.0):
            raise ValueError(f"prob must be in [0, 1], got {self.prob}")


@dataclass
class FaultDecision:
    action: str
    delay_s: float = 0.0


class FaultPlan:
    """Seeded, thread-safe decision engine consulted once per received
    frame. First matching rule that fires wins (rule order is priority)."""

    def __init__(self, rules: list[FaultRule], seed: int = 0):
        self._rules = list(rules)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.seed = seed
        self.frames = 0  # every frame this plan was consulted on

    def decide(self, cmd: str) -> FaultDecision | None:
        if cmd in _EXEMPT_CMDS:
            return None
        with self._lock:
            self.frames += 1
            for r in self._rules:
                if r.cmd != "*" and r.cmd != cmd:
                    continue
                r.seen += 1
                if r.max_fires >= 0 and r.fires >= r.max_fires:
                    continue
                fire = (
                    (r.seen % r.every == 0)
                    if r.every > 0
                    else (self._rng.random() < r.prob)
                )
                if not fire:
                    continue
                r.fires += 1
                wire_counters.inc(f"fault_{r.action}")
                return FaultDecision(r.action, r.delay_s)
        return None

    def stats(self) -> dict[str, int]:
        """Per-action fire totals plus the consulted-frame count (the
        denominator for "≥ X% of frames were perturbed" assertions)."""
        with self._lock:
            out = {"frames": self.frames}
            for r in self._rules:
                out[r.action] = out.get(r.action, 0) + r.fires
            return out

    # -- construction ----------------------------------------------------

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultPlan":
        spec = spec.strip()
        if not spec:
            raise ValueError("empty fault-plan spec")
        if spec.startswith("["):
            rules = [cls._rule_from_dict(d) for d in json.loads(spec)]
            return cls(rules, seed=seed)
        rules = []
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            tokens = [t.strip() for t in part.split(",")]
            kw: dict = {"action": tokens[0]}
            for tok in tokens[1:]:
                if "=" not in tok:
                    raise ValueError(
                        f"bad fault-rule token {tok!r} in {part!r} "
                        "(expected key=value)"
                    )
                k, v = tok.split("=", 1)
                kw[k] = v
            rules.append(cls._rule_from_dict(kw))
        return cls(rules, seed=seed)

    @staticmethod
    def _rule_from_dict(d: dict) -> FaultRule:
        # the documented spelling is ``max`` in BOTH spec forms (DSL and
        # JSON); the dataclass field is max_fires
        d = {{"max": "max_fires"}.get(k, k): v for k, v in d.items()}
        known = {"action", "cmd", "prob", "every", "delay_s", "max_fires"}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown fault-rule key(s) {sorted(unknown)}; known: "
                f"{sorted(known)}"
            )
        kw = dict(d)
        for k, cast in (
            ("prob", float), ("every", int), ("delay_s", float),
            ("max_fires", int),
        ):
            if k in kw:
                kw[k] = cast(kw[k])
        return FaultRule(**kw)

    @classmethod
    def from_env(cls, env: dict | None = None) -> "FaultPlan | None":
        """Build a plan from ``PS_FAULT_PLAN``/``PS_FAULT_SEED``; None when
        unset. Called by ``RpcServer`` at construction so every server in a
        spawned process tree arms itself from the launcher's environment."""
        env = os.environ if env is None else env
        spec = env.get(PLAN_ENV, "")
        if not spec:
            return None
        return cls.parse(spec, seed=int(env.get(SEED_ENV, "0")))
