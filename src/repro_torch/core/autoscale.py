"""Wave-level autoscaling: pick the next wave's size and fan-out from
measured launch telemetry instead of a static knob.

The paper's interactivity result (16,000 instances usable in ~5 minutes)
hinges on the metric Reuther et al. call time-to-first-result: users feel
the FIRST instance, not the last. A fixed wave size optimizes neither end
of the sweep — tiny waves pay the per-wave scheduler interaction
(``t_schedule``) once per handful of tasks, huge waves delay the first
result and stretch the core-level drain. ``WaveController`` closes the
loop AIMD-style over the per-wave ``LaunchRecord``:

  * **grow** (multiplicative, x2) while dispatch amortization dominates —
    ``t_schedule`` is a large fraction of the wave's wall clock, so a
    bigger wave amortizes the same submit cost over more tasks;
  * **shrink** (multiplicative, /2) when congestion signals appear: the
    core-level drain (``t_spawn - t_first_result``) dominates, a
    straggler re-dispatch fired, or ``t_first_result`` overruns the
    interactivity target;
  * **probe / revert** in the regime between: per-instance wave cost
    (``t_wave / n``) is tracked per size; once in a while the controller
    runs ONE wave a size down to measure whether smaller waves are
    cheaper (host-side staging and XLA temporaries can make the biggest
    wave the slowest — only measurement can tell), adopts the cheaper
    size, and reverts any size whose measured cost regresses >25%
    against the best size seen, capping future growth below it.

The same signals drive the per-wave ``inner_lanes`` (core-level) width:
lanes grow with the wave while amortization dominates and halve on
congestion, always dividing the wave so the node/core reshape is exact
(no silent fall-back to a flat vmap).

Doubling also maximizes compile reuse: wave sizes walk a power-of-two
ladder, so a warm ``CompileCache`` already holds every program the
controller will ask for on the next run.

Used via ``LLMapReduce(wave_size="auto")``; per-wave decisions are
recorded in ``LaunchRecord.extra["autoscale"]`` and summarized on the
``MapReduceReport``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core.telemetry import LaunchRecord


def _pow2_at_most(x: int) -> int:
    p = 1
    while p * 2 <= x:
        p *= 2
    return p


@dataclass
class Ewma:
    """Exponentially-weighted moving average — the one smoothing shape the
    repo's measured feedback loops share: the wave controller's per-size
    cost track here, and the distributed fabric's per-node capacity
    re-weighting (``NodeRegistry.observe_shard``). The first sample sets
    the value outright (no zero-bias warmup), so a signal is actionable
    after ONE measurement — which is what lets a slowed node's shards
    shrink within a wave or two instead of an asymptote."""

    alpha: float = 0.5
    value: Optional[float] = None
    n: int = 0

    def update(self, x: float) -> float:
        self.value = (x if self.value is None
                      else self.alpha * x + (1.0 - self.alpha) * self.value)
        self.n += 1
        return self.value


@dataclass
class WaveDecision:
    """One controller step: what was chosen for a wave, and why."""
    wave: int
    inner_lanes: int
    reason: str

    def as_extra(self) -> dict:
        return {"wave_size": self.wave, "inner_lanes": self.inner_lanes,
                "reason": self.reason}


@dataclass
class WaveController:
    """AIMD wave sizing from measured ``t_schedule`` / ``t_first_result``
    / drain. One controller instance drives one ``map_reduce`` call."""

    n_tasks: int
    devices: int = 1
    # hosts behind the backend (the distributed fabric's alive-node count):
    # a wave is sharded node-first, so the parallel width a wave must at
    # least cover is nodes x devices, and waves never shrink below the
    # fleet size (a wave smaller than the fleet idles whole nodes)
    nodes: int = 1
    start_wave: Optional[int] = None
    min_wave: int = 64
    max_wave: int = 4096
    max_lanes: int = 64
    # grow while the scheduler interaction is > this fraction of the wave
    # (below ~10% amortization has diminishing returns and bigger waves
    # only cost interactivity)
    grow_sched_frac: float = 0.10
    # shrink when the core-level drain exceeds this fraction of the wave
    shrink_drain_frac: float = 0.5
    # optional interactivity ceiling on time-to-first-result (seconds)
    target_first_result_s: Optional[float] = None

    def __post_init__(self):
        self.nodes = max(1, self.nodes)
        self.min_wave = max(self.min_wave, self.nodes)
        self.min_wave = max(1, min(self.min_wave, self.n_tasks))
        self.max_wave = max(self.min_wave, min(self.max_wave, self.n_tasks))
        # default start: n/4 rounded down to a power of two, capped at
        # 2048 — the first result still lands ~4x earlier than a single
        # monolithic wave (the interactivity metric) and the first waves
        # stay cache-friendly on the host staging path (probing/growth
        # takes it from there on measurement). Below ~4 x min_wave the
        # whole job is one efficient wave: slicing it cannot amortize
        # even its own extra dispatches
        if self.start_wave:
            wave = self.start_wave
        elif self.n_tasks <= 4 * self.min_wave:
            wave = self.n_tasks
        else:
            wave = min(_pow2_at_most(max(1, self.n_tasks // 4)), 2048)
        self.wave = max(self.min_wave, min(self.max_wave, wave))
        self.lanes_cap = self.max_lanes
        self._reason = "start"
        self._congested = 0
        self._grow_pressure = 0
        self.cost: dict = {}          # wave size -> Ewma cost per instance
        self.ceiling = 2 * self.max_wave  # sizes >= a measured-bad size: off
        self.committed = False        # stop probing once a winner is clear
        self._probe_from: Optional[int] = None

    # -- decisions ---------------------------------------------------------
    def _pick_lanes(self, wave: int) -> int:
        """Largest power-of-two core-level width that divides the wave,
        keeps the node level at least as wide as the fabric's parallel
        width (devices x nodes), and respects the congestion-adjusted cap.

        With a single device on a single host there is no node level to
        shard, so the measured winner is the flat vmap (the nested
        node/core reshape costs ~25% on CPU XLA for nothing) — lanes stay
        at 1."""
        width = self.devices * self.nodes
        if width <= 1:
            return 1
        cap = max(1, min(self.lanes_cap, self.max_lanes))
        lanes = 1
        while (lanes * 2 <= cap and wave % (lanes * 2) == 0
               and wave // (lanes * 2) >= width):
            lanes *= 2
        return lanes

    def next_wave(self, remaining: int) -> WaveDecision:
        """Size the next wave. ``remaining`` bounds it; a near-tail wave
        absorbs the remainder (up to 1.5x the current wave, never past
        ``max_wave``) so the ladder does not leave a runt wave — each
        distinct wave shape is a distinct compiled program, and a runt
        buys nothing but one more dispatch + compile."""
        wave = min(self.wave, remaining)
        if wave < remaining <= min(wave + wave // 2, self.max_wave):
            wave = remaining
        # the caller (LLMapReduce) keeps the decision log, on the report
        return WaveDecision(wave, self._pick_lanes(wave), self._reason)

    # -- feedback ----------------------------------------------------------
    def observe(self, rec: LaunchRecord, t_wave: float,
                straggler: bool = False,
                tasks_left: Optional[int] = None) -> None:
        """Feed one completed wave's record back into the controller.
        ``tasks_left`` (undispatched tasks) gates downward probing: a
        probe only pays if enough future waves can exploit its answer."""
        t_wave = max(t_wave, 1e-9)
        n = max(1, rec.n_instances)
        cost = t_wave / n
        nominal = n == self.wave      # tail/absorbed waves are not ladder
        if nominal:                   # samples; don't let them steer
            self.cost.setdefault(n, Ewma(alpha=0.5)).update(cost)
        sched_frac = rec.t_schedule / t_wave
        drain_frac = max(rec.t_spawn - rec.t_first_result, 0.0) / t_wave
        late_first = (self.target_first_result_s is not None
                      and rec.t_first_result > self.target_first_result_s)
        if straggler:
            # a fired re-dispatch is an unambiguous signal: shrink now
            self._congested = 0
            self._probe_from = None
            self._shrink(f"straggler@{rec.n_instances}")
            return
        if drain_frac > self.shrink_drain_frac or late_first:
            # drain / late-first-result need hysteresis: a single sample
            # is easily an artifact of delayed harvest polling (the
            # driver was busy dispatching), not of wave size
            self._congested += 1
            if self._congested >= 2:
                self._congested = 0
                self._probe_from = None
                self._shrink(f"drain_frac={drain_frac:.2f}" if not late_first
                             else f"t_first={rec.t_first_result:.3f}s")
            else:
                self._reason = "hold:congestion-debounce"
            return
        self._congested = 0
        if not nominal:
            self._reason = "hold:tail"
            return
        if self._probe_from is not None:
            # this wave WAS the downward probe: adopt the smaller size if
            # measurably cheaper per instance, else return and commit
            came_from = self._probe_from
            self._probe_from = None
            came_cost = (self.cost[came_from].value
                         if came_from in self.cost else float("inf"))
            if cost < 0.95 * came_cost:
                self._reason = f"adopt:{self.wave}"
                return                # keep probing down next round
            self.wave = came_from
            self.committed = True
            self._reason = f"return:{came_from}"
            return
        best_w = min(self.cost, key=lambda w: self.cost[w].value)
        if cost > 1.25 * self.cost[best_w].value and best_w != self.wave:
            # this size is measurably worse than one already measured:
            # go back there and stop exploring at or past this size
            self.ceiling = min(self.ceiling, self.wave)
            self.wave = best_w
            self.committed = True
            self._reason = (f"revert:{cost * 1e6:.0f}us/inst"
                            f">best@{best_w}")
            return
        if sched_frac > self.grow_sched_frac:
            # debounce like shrink: one sample hovering at the boundary
            # must not flap the ladder (a clearly dispatch-dominated
            # workload re-signals on the very next wave)
            self._grow_pressure += 1
            if self._grow_pressure >= 2 or sched_frac > 2 * self.grow_sched_frac:
                self._grow_pressure = 0
                self._grow(f"sched_frac={sched_frac:.2f}")
            else:
                self._reason = "hold:grow-debounce"
            return
        self._grow_pressure = 0
        down = self.wave // 2
        enough_left = tasks_left is None or tasks_left > 4 * self.wave
        if (not self.committed and enough_left and down >= self.min_wave
                and down not in self.cost):
            # amortization is satisfied; probe ONE wave a size down — the
            # only way to learn whether smaller waves are cheaper per
            # instance (host staging + XLA temps can punish big waves)
            self._probe_from = self.wave
            self.wave = down
            self._reason = f"probe:{down}"
            return
        self.committed = True
        self._reason = "hold"

    def _grow(self, why: str) -> None:
        new = min(self.max_wave, self.wave * 2)
        if new >= self.ceiling:       # a measured-bad size caps growth
            self._reason = f"hold:ceiling@{self.ceiling}"
            return
        self.wave = new
        self.lanes_cap = min(self.max_lanes, self.lanes_cap * 2)
        self._reason = f"grow:{why}"

    def _shrink(self, why: str) -> None:
        self.wave = max(self.min_wave, _pow2_at_most(max(self.wave // 2, 1)))
        self.lanes_cap = max(1, self.lanes_cap // 2)
        self._reason = f"shrink:{why}"
