"""Cycle-accurate discrete-event simulator of MAGIA synchronization (paper §4.1);
the port's copy of ``repro/core/simulator.py`` (equal cycles).

Reproduces Table 1: the latency of four barrier schemes on tile meshes from
*Neighbor* (two adjacent tiles) up to 16×16:

  * **FSync**    — native FractalSync H-tree (dedicated wires, no NoC traffic).
  * **FSync+P**  — FractalSync with pipeline registers on wires longer than one
                   NoC pitch (closes 1 GHz timing; paper's headline scheme).
  * **Naïve**    — software barrier via atomic memory operations (AMOs) to a
                   single master tile over the NoC: fetch-add a counter, last
                   arriver writes a release flag, everyone else spin-polls it.
  * **XY**       — dimension-ordered software barrier: each row barriers on its
                   row-master (phase 1), row-masters barrier on the global
                   master (phase 2), release cascades back. Linear scaling.

The NoC model is an XY-routed 2D mesh with contended links (1-flit messages,
store-and-forward, per-hop latency + link occupancy) and a per-tile AMO unit
that serializes atomic operations (models MAGIA's HCI AMO module). Software
overheads (issue, poll loop, exit) are parameters; ``DEFAULT_PARAMS`` was
calibrated against Table 1 (see ``core/calibrate.py``).

Synchronization overhead metric (paper §4.1):  Ŝ := max(F) − max(R), where R
are the cycles at which tiles request synchronization and F the cycles at which
they execute the instruction following synchronization.
"""

from __future__ import annotations

import heapq
import itertools
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import schedule_ir
from .tree import FractalTree

Coord = Tuple[int, int]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SimParams:
    """Micro-architectural + software constants (cycles @ 1 GHz).

    Calibrated against the paper's Table 1 AMO baselines (16 KiB I$, cache
    pre-heating). The FractalSync columns are parameter-free (pure topology).
    """

    hop_latency: int = 4        # router→router traversal (FlooNoC-like)
    link_occupancy: int = 3     # cycles a 1-flit msg holds a link
    inj_latency: int = 0        # tile↔router network-interface latency
    amo_service: int = 11       # AMO unit service time per op (HCI + bank)
    sw_pre: int = 0             # sync request → first AMO issued
    sw_between: int = 17        # gap between dependent ops in SW
    sw_poll: int = 22           # spin-loop overhead between polls
    sw_post: int = 3            # release observed → next instruction retires


DEFAULT_PARAMS = SimParams()


# ---------------------------------------------------------------------------
# Event engine
# ---------------------------------------------------------------------------


class SimBudgetExceeded(RuntimeError):
    """Simulation ran past its cycle/event budget (pathological parameters)."""


class EventSim:
    """Minimal deterministic discrete-event engine."""

    def __init__(self) -> None:
        self.now = 0
        self._q: List[Tuple[int, int, Callable[[int], None]]] = []
        self._seq = itertools.count()

    def at(self, time: int, fn: Callable[[int], None]) -> None:
        if time < self.now:
            raise RuntimeError(f"scheduling into the past: {time} < {self.now}")
        heapq.heappush(self._q, (time, next(self._seq), fn))

    def run(self, horizon: int = 200_000, max_events: int = 2_000_000) -> None:
        events = 0
        while self._q:
            t, _, fn = heapq.heappop(self._q)
            events += 1
            if t > horizon or events > max_events:
                raise SimBudgetExceeded(
                    f"simulation exceeded budget (t={t}, events={events})")
            self.now = t
            fn(t)


# ---------------------------------------------------------------------------
# NoC: XY-routed 2D mesh with contended links
# ---------------------------------------------------------------------------


class NoC:
    """XY dimension-ordered routing, single physical channel (paper §2.2).

    Links (incl. tile↔router injection/ejection ports) are modeled as
    resources with an occupancy window; 1-flit messages advance hop-by-hop.
    Contention at the master tile's ejection port is what makes centralized
    AMO barriers quadratic — exactly the effect the paper measures.
    """

    def __init__(self, sim: EventSim, rows: int, cols: int, p: SimParams):
        self.sim = sim
        self.rows, self.cols = rows, cols
        self.p = p
        self.link_free: Dict[tuple, int] = defaultdict(int)
        self.total_msgs = 0
        self.total_hops = 0

    def _path(self, src: Coord, dst: Coord) -> List[tuple]:
        """List of (link_key, latency) from src tile to dst tile."""
        links: List[tuple] = [(("inj", src), self.p.inj_latency)]
        r, c = src
        while c != dst[1]:
            nc = c + (1 if dst[1] > c else -1)
            links.append(((("rtr", (r, c)), ("rtr", (r, nc))), self.p.hop_latency))
            c = nc
        while r != dst[0]:
            nr = r + (1 if dst[0] > r else -1)
            links.append(((("rtr", (r, c)), ("rtr", (nr, c))), self.p.hop_latency))
            r = nr
        links.append((("ej", dst), self.p.inj_latency))
        return links

    def send(self, t: int, src: Coord, dst: Coord,
             on_deliver: Callable[[int], None], flits: int = 1) -> None:
        """Inject a message at time t; call on_deliver at (tail) arrival.

        ``flits > 1`` models payload-carrying messages: each traversed link
        is held for ``flits · link_occupancy`` cycles and the tail trails
        the head by the serialization delay (wormhole-ish store-and-forward,
        used by ``schedule_on_noc`` for all-reduce payloads)."""
        assert src != dst, "local operations must not use the NoC"
        path = self._path(src, dst)
        self.total_msgs += 1
        self.total_hops += len(path) - 2
        occupy = self.p.link_occupancy * max(1, flits)
        serial = self.p.link_occupancy * (max(1, flits) - 1)

        def advance(i: int, t: int) -> None:
            if i == len(path):
                on_deliver(t)
                return
            key, lat = path[i]
            free = self.link_free[key]
            if free > t:
                self.sim.at(free, lambda tt: advance(i, tt))
                return
            self.link_free[key] = t + occupy
            self.sim.at(t + lat + serial, lambda tt: advance(i + 1, tt))

        advance(0, t)


# ---------------------------------------------------------------------------
# AMO unit (per tile): serializes atomic ops on that tile's L1
# ---------------------------------------------------------------------------


class AMOUnit:
    def __init__(self, sim: EventSim, p: SimParams):
        self.sim = sim
        self.p = p
        self.busy_until = 0
        self.mem: Dict[str, int] = defaultdict(int)
        self.ops_served = 0

    def request(self, t: int, op: str, addr: str, val: int,
                reply: Callable[[int, int], None]) -> None:
        """op ∈ {fetch_add, read, write}; reply(time, old_value)."""
        start = max(t, self.busy_until)
        done = start + self.p.amo_service
        self.busy_until = done
        self.ops_served += 1

        def fire(tt: int) -> None:
            old = self.mem[addr]
            if op == "fetch_add":
                self.mem[addr] = old + val
            elif op == "write":
                self.mem[addr] = val
            elif op != "read":
                raise ValueError(op)
            reply(tt, old)

        self.sim.at(done, fire)


# ---------------------------------------------------------------------------
# Software AMO barrier schemes (the paper's baselines)
# ---------------------------------------------------------------------------


class _AMOMachine:
    """Shared plumbing: issue an AMO op to a (possibly remote) tile."""

    def __init__(self, rows: int, cols: int, p: SimParams):
        self.rows, self.cols = rows, cols
        self.p = p
        self.sim = EventSim()
        self.noc = NoC(self.sim, rows, cols, p)
        self.amo = {
            (r, c): AMOUnit(self.sim, p)
            for r in range(rows) for c in range(cols)
        }
        self.finish: Dict[Coord, int] = {}

    def tiles(self) -> List[Coord]:
        return [(r, c) for r in range(self.rows) for c in range(self.cols)]

    def amo_op(self, t: int, src: Coord, dst: Coord, op: str, addr: str,
               val: int, reply: Callable[[int, int], None]) -> None:
        """Round-trip AMO: NoC request → AMO unit → NoC response (or local)."""
        unit = self.amo[dst]
        if src == dst:
            unit.request(t, op, addr, val, reply)
            return

        def deliver_req(tt: int) -> None:
            unit.request(tt, op, addr, val,
                         lambda td, old: self.noc.send(
                             td, dst, src, lambda ta: reply(ta, old)))

        self.noc.send(t, src, dst, deliver_req)

    def overhead(self, requests: Dict[Coord, int]) -> int:
        """Ŝ = max(F) − max(R)."""
        return max(self.finish.values()) - max(requests.values())


class HierarchicalAMOBarrier(_AMOMachine):
    """Generic AMO barrier executor over any gather-tree barrier Program.

    The IR supplies the *topology* — its reduce steps, bottom-up, define the
    levels of a synchronization hierarchy (group members per master); this
    class supplies the *protocol* the paper's software baselines use:

      * lower levels: members fetch-add the group counter at their master
        and spin-poll the group flag over the NoC; the master local-polls
        its counter and escalates to the next level when the group is in;
      * top level: all participants (incl. the master) fetch-add at the top
        master; the last arriver writes the release flag, everyone else
        spin-polls it; release then cascades down through the group flags.

    ``NaiveBarrier`` (star topology), ``XYBarrier`` (row/column 2-level
    tree) and ``tree_amo_barrier`` (full H-tree, SynCron-style) are just IR
    instances of this executor — one protocol, many topologies.
    """

    def __init__(self, prog: schedule_ir.Program,
                 p: SimParams = DEFAULT_PARAMS):
        rows, cols = schedule_ir.as_2d(prog.shape)
        super().__init__(rows, cols, p)
        self.prog = prog
        # bottom-up levels from the IR's reduce (gather) steps
        self.levels: List[Dict[Coord, List[Coord]]] = []
        for step in prog.steps:
            if not step.transfers or not all(t.reduce for t in step.transfers):
                continue  # broadcast mirror steps: release is protocol-implied
            groups: Dict[Coord, List[Coord]] = defaultdict(list)
            for t in step.transfers:
                groups[self._coord(t.dst)].append(self._coord(t.src))
            self.levels.append(dict(groups))
        if not self.levels:
            raise ValueError(f"{prog.name!r} has no gather steps")
        self._member_master: List[Dict[Coord, Coord]] = [
            {m: master for master, ms in lvl.items() for m in ms}
            for lvl in self.levels
        ]

    def _coord(self, rank: int) -> Coord:
        return divmod(rank, self.cols)

    def _entry_level(self, tile: Coord) -> Optional[int]:
        for lvl, groups in enumerate(self.levels):
            if tile in groups or tile in self._member_master[lvl]:
                return lvl
        return None

    def run(self, requests: Optional[Dict[Coord, int]] = None) -> int:
        tiles = self.tiles()
        requests = requests or {t: 0 for t in tiles}
        p = self.p
        top = len(self.levels) - 1

        def addr(kind: str, lvl: int) -> str:
            return f"{kind}{lvl}"

        def poll_remote(x: Coord, at: Coord, a: str,
                        on_set: Callable[[int], None], t: int) -> None:
            def on_rd(tt: int, v: int) -> None:
                if v:
                    on_set(tt)
                else:
                    self.sim.at(tt + p.sw_poll,
                                lambda t2: poll_remote(x, at, a, on_set, t2))
            self.amo_op(t, x, at, "read", a, 0, on_rd)

        def descend(x: Coord, lvl: int, t: int) -> None:
            """x released at level lvl+1: publish its own group flags down."""
            if lvl < 0 or x not in self.levels[lvl]:
                self.finish[x] = t + p.sw_post
                return

            def on_wr(tt: int, _o: int) -> None:
                descend(x, lvl - 1, tt)
            self.amo_op(t + p.sw_between, x, x, "write", addr("flag", lvl),
                        1, on_wr)

        def arrive(x: Coord, lvl: int, t: int) -> None:
            pre = p.sw_pre if lvl == 0 else p.sw_between
            if lvl == top:
                (master, members), = self.levels[lvl].items()
                target = len(members) + 1  # master fetch-adds too

                def on_count(tt: int, old: int) -> None:
                    if old == target - 1:    # last arriver: release everyone
                        def on_release(td: int, _o: int) -> None:
                            descend(x, lvl - 1, td)
                        self.amo_op(tt + p.sw_between, x, master, "write",
                                    addr("flag", lvl), 1, on_release)
                    else:
                        self.sim.at(tt + p.sw_between,
                                    lambda t2: poll_remote(
                                        x, master, addr("flag", lvl),
                                        lambda td: descend(x, lvl - 1, td),
                                        t2))
                self.amo_op(t + pre, x, master, "fetch_add",
                            addr("cnt", lvl), 1, on_count)
            elif x in self.levels[lvl]:
                # group master: spin-poll the LOCAL counter, then escalate
                members = self.levels[lvl][x]

                def wait_group(tt: int) -> None:
                    def on_rd(td: int, v: int) -> None:
                        if v == len(members):
                            arrive(x, lvl + 1, td)
                        else:
                            self.sim.at(td + p.sw_poll, wait_group)
                    self.amo_op(tt, x, x, "read", addr("cnt", lvl), 0, on_rd)
                self.sim.at(t + pre, wait_group)
            else:
                # member: fetch-add at the master, then poll the group flag
                master = self._member_master[lvl][x]

                def on_count(tt: int, _old: int) -> None:
                    self.sim.at(tt + p.sw_between,
                                lambda t2: poll_remote(
                                    x, master, addr("flag", lvl),
                                    lambda td: descend(x, lvl - 1, td), t2))
                self.amo_op(t + pre, x, master, "fetch_add",
                            addr("cnt", lvl), 1, on_count)

        for tile, r in requests.items():
            lvl = self._entry_level(tile)
            if lvl is None:     # world of 1: nothing to synchronize
                self.finish[tile] = r
                continue
            self.sim.at(r, lambda t, tile=tile, lvl=lvl: arrive(tile, lvl, t))
        self.sim.run()
        return self.overhead(requests)


class NaiveBarrier(HierarchicalAMOBarrier):
    """Single master tile accepts requests and dispatches responses (§4.1):
    the star-topology instance of the generic AMO executor."""

    def __init__(self, rows: int, cols: int, p: SimParams = DEFAULT_PARAMS):
        super().__init__(schedule_ir.naive_barrier((rows, cols)), p)

    def run(self, requests: Optional[Dict[Coord, int]] = None,
            master: Coord = (0, 0)) -> int:
        if master != (0, 0):
            root = master[0] * self.cols + master[1]
            world = self.rows * self.cols
            gather = schedule_ir.Step(tuple(
                schedule_ir.Transfer(r, root, (0,), reduce=True)
                for r in range(world) if r != root), level=1)
            prog = schedule_ir.Program("naive_barrier",
                                       (self.rows, self.cols), 1, (gather,),
                                       kind=schedule_ir.BARRIER)
            HierarchicalAMOBarrier.__init__(self, prog, self.p)
        return super().run(requests)


class XYBarrier(HierarchicalAMOBarrier):
    """Two 1D phases: rows barrier on row-masters (col 0), then row-masters
    barrier on the global master (0,0); release cascades back (§4.1): the
    two-level-tree instance of the generic AMO executor."""

    def __init__(self, rows: int, cols: int, p: SimParams = DEFAULT_PARAMS):
        super().__init__(schedule_ir.xy_barrier((rows, cols)), p)


def tree_amo_barrier(shape: Tuple[int, ...],
                     p: SimParams = DEFAULT_PARAMS) -> HierarchicalAMOBarrier:
    """Beyond-paper software baseline: the H-tree topology run with AMO
    counters/flags instead of dedicated FS modules (SynCron-style
    hierarchical synchronization) — log-depth, but each level pays the
    full software counter/poll protocol."""
    return HierarchicalAMOBarrier(schedule_ir.tree_barrier(shape), p)


# ---------------------------------------------------------------------------
# FractalSync event model (dedicated H-tree network, §3)
# ---------------------------------------------------------------------------


class FractalSyncSim:
    """Event-driven model of the FS tree with arbitrary arrival skew.

    Up-edge into a level-l module costs 1 cycle (FSM) plus, if pipelined, the
    level's pipeline registers; the down (wake) path mirrors it; +2 cycles for
    request sampling and wake detection at the tile.  With aligned arrivals
    this equals ``FractalTree.fsync_latency`` (Table 1 exactly).
    """

    def __init__(self, tree: FractalTree, pipelined: bool = False):
        self.tree = tree
        self.pipelined = pipelined

    def run(self, requests: Optional[Dict[tuple, int]] = None,
            level: Optional[int] = None) -> Tuple[int, Dict[tuple, int]]:
        tree = self.tree
        level = tree.num_levels if level is None else level
        tiles = list(tree.tiles())
        requests = requests or {t: 0 for t in tiles}

        # Upward sweep: module at (lvl, key) fires at max(children)+cost(lvl).
        fire_time: Dict[tuple, int] = {}
        arrive: Dict[tuple, int] = {("tile", t): requests[t] + 1 for t in tiles}
        groups: Dict[tuple, List[int]] = defaultdict(list)
        for t in tiles:
            groups[tree.domain_key(t, 1)].append(arrive[("tile", t)])
        prev = {k: v for k, v in groups.items()}
        for lvl in range(1, level + 1):
            spec = tree.level(lvl)
            cost = 1 + (spec.pipeline_regs if self.pipelined else 0)
            nxt: Dict[tuple, List[int]] = defaultdict(list)
            fired: Dict[tuple, int] = {}
            for key, times in prev.items():
                fired[key] = max(times) + cost
            fire_time.update({(lvl, k): v for k, v in fired.items()})
            if lvl < level:
                for t in tiles:
                    k_here = tree.domain_key(t, lvl)
                    k_up = tree.domain_key(t, lvl + 1)
                    nxt[k_up].append(fired[k_here])
                # dedupe: each module reports once, not once per tile
                prev = {k: sorted(set(v)) for k, v in nxt.items()}

        # Downward sweep: wake propagates back through the same edges.
        down_cost = sum(
            1 + (tree.level(l).pipeline_regs if self.pipelined else 0)
            for l in range(1, level + 1)
        )
        finish: Dict[tuple, int] = {}
        for t in tiles:
            root_key = tree.domain_key(t, level)
            finish[t] = fire_time[(level, root_key)] + down_cost + 1

        overhead = max(finish.values()) - max(requests.values())
        return overhead, finish


# ---------------------------------------------------------------------------
# Generic NoC replay of any Schedule IR program
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NoCReplay:
    """Result of replaying an IR program on the contended mesh NoC."""

    overhead: int                  # Ŝ = max(F) − max(R), cycles
    finish: Dict[int, int]         # per flat rank
    total_msgs: int
    total_hops: int

    def __float__(self) -> float:
        return float(self.overhead)


@dataclass(frozen=True)
class PipelineReplay:
    """Result of replaying a *sequence* of bucket programs on one NoC.

    ``program_finish[i]`` is the cycle at which the last rank completed
    program i — the simulated analogue of ``OverlapTimeline.comm_end_s``,
    with link contention between in-flight buckets included.
    """

    overhead: int                  # max(F) − max(R) across the whole pipeline
    finish: Dict[int, int]         # per flat rank, after the last program
    program_finish: Tuple[int, ...]
    total_msgs: int
    total_hops: int

    def __float__(self) -> float:
        return float(self.overhead)


def pipelined_on_noc(progs: Sequence[schedule_ir.Program],
                     params: SimParams = DEFAULT_PARAMS,
                     payload_flits: Optional[Sequence[int]] = None,
                     ready: Optional[Sequence[int]] = None,
                     requests: Optional[Dict[int, int]] = None
                     ) -> PipelineReplay:
    """Replay a pipeline of IR programs (superstep buckets) on a shared NoC.

    Each rank advances through the concatenated step sequence BSP-style:
    entering a step it issues its messages (size ∝ chunk fraction of that
    program's ``payload_flits``), then waits for every message addressed to
    it in that step before advancing.  A rank may not enter program i before
    cycle ``ready[i]`` (gradient-readiness during backward) — but ranks
    progress *independently*, so bucket i+1's messages from fast ranks
    contend on the NoC with bucket i's stragglers: the overlap-aware mode
    the cost model approximates analytically, simulated with real link
    contention.
    """
    if not progs:
        raise ValueError("need at least one program")
    shape = progs[0].shape
    if any(p.shape != shape for p in progs):
        raise ValueError("all pipelined programs must share one mesh shape")
    flits = list(payload_flits) if payload_flits is not None \
        else [1] * len(progs)
    ready = list(ready) if ready is not None else [0] * len(progs)
    if not (len(progs) == len(flits) == len(ready)):
        raise ValueError("progs, payload_flits, ready must align")

    rows, cols = schedule_ir.as_2d(shape)
    world = progs[0].world
    requests = requests or {r: 0 for r in range(world)}
    sim = EventSim()
    noc = NoC(sim, rows, cols, params)
    p = params
    coord = lambda r: divmod(r, cols)  # noqa: E731

    # concatenate the programs' steps; remember which program owns each step
    steps: List[Tuple[int, schedule_ir.Step]] = []
    start_step = []            # first combined-step index of each program
    for i, prog in enumerate(progs):
        start_step.append(len(steps))
        steps.extend((i, st) for st in prog.steps)
    n_steps = len(steps)
    boundary = {s: i for i, s in enumerate(start_step)}   # step → program
    last_of = {start_step[i + 1] - 1: i for i in range(len(progs) - 1)}
    if n_steps:
        last_of[n_steps - 1] = len(progs) - 1

    sends: List[List[List[schedule_ir.Transfer]]] = [
        [[] for _ in range(n_steps)] for _ in range(world)]
    expected = [[0] * n_steps for _ in range(world)]
    for s, (_, step) in enumerate(steps):
        for t in step.transfers:
            sends[t.src][s].append(t)
            expected[t.dst][s] += 1

    got = [[0] * n_steps for _ in range(world)]
    arr_t = [[0] * n_steps for _ in range(world)]
    entered = [[None] * n_steps for _ in range(world)]
    advanced = [[False] * n_steps for _ in range(world)]
    finish: Dict[int, int] = {}
    prog_finish = [0] * len(progs)

    def flits_of(s: int, tr: schedule_ir.Transfer) -> int:
        i = steps[s][0]
        return max(1, round(len(tr.chunks) / progs[i].n_chunks * flits[i]))

    def try_advance(r: int, s: int) -> None:
        if entered[r][s] is None or got[r][s] < expected[r][s] \
                or advanced[r][s]:
            return
        advanced[r][s] = True
        # bounce through the event queue: long runs of pass-through steps
        # (e.g. a naive rank waiting its serial turn) must not recurse
        done = max(entered[r][s], arr_t[r][s], sim.now)
        if s in last_of:
            prog_finish[last_of[s]] = max(prog_finish[last_of[s]], done)
        sim.at(done, lambda tt, r=r, s=s: enter(r, s + 1, tt))

    def enter(r: int, s: int, t: int) -> None:
        if s == n_steps:
            finish[r] = t + p.sw_post
            return
        if s in boundary:      # bucket i's grads not ready before ready[i]
            t = max(t, ready[boundary[s]])
        # software issue overhead only where the rank actually acts; idle
        # pass-through steps (e.g. a naive rank waiting its serial turn)
        # cost nothing — the rank is simply parked on its receive
        t_issue = t + ((p.sw_pre if s == 0 else p.sw_between)
                       if sends[r][s] else 0)
        for tr in sends[r][s]:
            def deliver(tt: int, tr=tr, s=s) -> None:
                d = tr.dst
                got[d][s] += 1
                arr_t[d][s] = max(arr_t[d][s], tt)
                try_advance(d, s)
            sim.at(t_issue,
                   lambda tt, tr=tr, s=s, deliver=deliver: noc.send(
                       tt, coord(tr.src), coord(tr.dst), deliver,
                       flits=flits_of(s, tr)))
        entered[r][s] = t_issue
        try_advance(r, s)

    for r, t0 in requests.items():
        sim.at(t0, lambda t, r=r: enter(r, 0, t))
    max_flits = max([1, *flits])
    horizon = max(200_000, 1000 * (n_steps + 1) * max_flits,
                  2 * max([0, *ready]) + 1000 * (n_steps + 1) * max_flits)
    sim.run(horizon=horizon,
            max_events=5_000_000 + 200 * world * max(1, n_steps))
    overhead = max(finish.values()) - max(requests.values())
    return PipelineReplay(overhead=overhead, finish=finish,
                          program_finish=tuple(prog_finish),
                          total_msgs=noc.total_msgs,
                          total_hops=noc.total_hops)


def schedule_on_noc(prog: schedule_ir.Program,
                    params: SimParams = DEFAULT_PARAMS,
                    payload_flits: int = 1,
                    requests: Optional[Dict[int, int]] = None) -> NoCReplay:
    """Replay one Schedule IR program on the XY-routed contended mesh.

    The single-program view of ``pipelined_on_noc``: per-rank progress is
    asynchronous but data dependencies are honored, giving *simulated*
    latency (link contention included) for every software schedule, not
    just the two AMO baselines the paper measures.
    """
    out = pipelined_on_noc([prog], params, [payload_flits], [0], requests)
    return NoCReplay(overhead=out.overhead, finish=out.finish,
                     total_msgs=out.total_msgs, total_hops=out.total_hops)


def software_schedule_latency(schedule: str, shape: Tuple[int, ...],
                              params: SimParams = DEFAULT_PARAMS,
                              payload_flits: int = 1) -> int:
    """Simulated NoC latency of a *software all-reduce schedule* (cycles)."""
    prog = schedule_ir.build_program(schedule, tuple(shape))
    return schedule_on_noc(prog, params, payload_flits).overhead


# ---------------------------------------------------------------------------
# Table 1 entry points
# ---------------------------------------------------------------------------

PAPER_TABLE1 = {
    # mesh: (FSync, FSync+P, Naive, XY, speedup "FSync+P vs best AMO")
    "Neighbor": (4, 4, 79, 79, 19),
    "2x2": (6, 6, 119, 219, 19),
    "4x4": (10, 10, 512, 347, 34),
    "8x8": (14, 18, 2488, 614, 34),
    "16x16": (18, 34, 13961, 1462, 43),
}


def _mesh_of(name: str) -> Tuple[int, int]:
    if name == "Neighbor":
        return (1, 2)
    k = int(name.split("x")[0])
    return (k, k)


def simulate_config(name: str, params: SimParams = DEFAULT_PARAMS
                    ) -> Dict[str, float]:
    rows, cols = _mesh_of(name)
    tree = FractalTree((rows, cols))
    fsync = tree.fsync_latency()
    fsync_p = tree.fsync_latency(pipelined=True)
    naive = NaiveBarrier(rows, cols, params).run()
    # Paper reports identical Neighbor numbers for Naive and XY (2 tiles: XY
    # degenerates to the centralized scheme).
    xy = naive if rows * cols == 2 else XYBarrier(rows, cols, params).run()
    best_amo = min(naive, xy)
    return {
        "fsync": fsync,
        "fsync_p": fsync_p,
        "naive": naive,
        "xy": xy,
        "best_amo": best_amo,
        "speedup": best_amo / fsync_p,
    }


def table1(params: SimParams = DEFAULT_PARAMS,
           configs: Sequence[str] = tuple(PAPER_TABLE1)) -> Dict[str, Dict[str, float]]:
    return {name: simulate_config(name, params) for name in configs}


def scaling_sweep(ks: Sequence[int] = (2, 4, 8, 16, 32, 64),
                  params: SimParams = DEFAULT_PARAMS,
                  max_amo_k: int = 16) -> Dict[str, Dict[str, float]]:
    """Beyond-paper: extend the sweep past 16×16. AMO sims above ``max_amo_k``
    are skipped (quadratic event counts); FSync columns are analytic."""
    out: Dict[str, Dict[str, float]] = {}
    for k in ks:
        name = f"{k}x{k}"
        tree = FractalTree((k, k))
        row: Dict[str, float] = {
            "fsync": tree.fsync_latency(),
            "fsync_p": tree.fsync_latency(pipelined=True),
        }
        if k <= max_amo_k:
            row.update(
                naive=NaiveBarrier(k, k, params).run(),
                xy=XYBarrier(k, k, params).run(),
            )
            row["speedup"] = min(row["naive"], row["xy"]) / row["fsync_p"]
        out[name] = row
    return out
