"""The port's multi-robot coordination path (``multirobot/``, ``metrics.py``,
``utils/datasaver.py``) against the JAX package's, on the CPU at f64.

(a) Host functions on seeded numpy inputs, bit-equal to JAX's:
    ``interpolate_trajectory_by_elapsed_time``, ``collision_mask_gk``,
    ``geometric_deviation`` and the prioritized triggers of
    ``decide_communication``.
(b) Lockstep drivers: a JAX and a port ``MultiRobotDriver`` with two
    ``goal_tmpc`` robots (N=8) on the head-on scene of the JAX suite, one
    simulated clock each, cycle by cycle. Both packages' T-MPC optimizers
    are intercepted at ``_dispatch_batch``/``_fetch_batch`` (as in
    tests/test_torch_tick.py): the dispatched params, xinit and warm starts
    agree to 1e-12, the port's plain fused solve runs once and both sides
    get its result. Then everything the host does agrees: exactly the FSM
    states, the trigger reasons, ``n_sent`` and every published
    ``TrajectoryMessage``; to 1e-10 the continuous values (the peer
    obstacles after interpolation, the commands, the states after
    ``apply_command``: the port integrates on the host in f64, JAX on its
    default device). No JAX SQP program is compiled.
(c) The port alone: the head-on scene at N=12 with the JAX test's
    assertions, the FSM startup sequence, the late joiner through the
    trajectory service, error-state entry and recovery, the invalid
    transition guard, and ``run_experiments`` on the desynchronized driver
    with ``ExperimentUtil`` writing into ``tmp_path`` (N=8, short episodes:
    segmentation, export and jittered schedules, not completion). The
    three-robot intersection runs at full width on the card
    (``chip_smoke.py``, phase (i)).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from oscar_mpc_planner_mr_modification_tpu import factory as j_factory  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu import multirobot as j_mr  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu import types as j_types  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.multirobot import comms as j_comms  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.multirobot import (  # noqa: E402
    interpolation as j_interp)
from oscar_mpc_planner_mr_modification_tpu.ops import sqp as j_sqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.utils import (  # noqa: E402
    default_settings as j_settings)

from oscar_mpc_planner_mr_modification_tpu_torch import factory as t_factory  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch import multirobot as t_mr  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch import types as t_types  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.multirobot import (  # noqa: E402
    comms as t_comms)
from oscar_mpc_planner_mr_modification_tpu_torch.multirobot import (  # noqa: E402
    interpolation as t_interp)
from oscar_mpc_planner_mr_modification_tpu_torch.ops import sqp as t_sqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.ops import sqp_fused  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.utils import (  # noqa: E402
    default_settings as t_settings)

F64 = torch.float64
PS_T = t_types.PlannerState
#: The robots' SQP (the JAX suite's 5 x 10) under the kernel's regularization.
CFG = dict(n_sqp=5, n_qp_iter=10, regularization="gershgorin")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# (a) Host functions, bit-equal
# ---------------------------------------------------------------------------
def _equal(a, b):
    if a is None or b is None:
        return a is None and b is None
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def test_interpolation_bit_equal_to_jax():
    """200 seeded trajectories (straight, turning, too fast, too short) at
    elapsed times from fresh to too stale: the same arrays bit for bit, and
    the same early-outs."""
    rng = np.random.default_rng(0)
    n_none = 0
    for case in range(200):
        N = int(rng.integers(1, 16))
        dt = float(rng.choice([0.1, 0.2]))
        v = rng.uniform(0.0, 4.0)
        psi = np.cumsum(rng.normal(0.0, 0.3, N))
        pos = np.cumsum(np.stack([np.cos(psi), np.sin(psi)], 1) * v * dt, 0)
        pos = pos + rng.normal(0.0, 0.01, pos.shape)
        elapsed = float(rng.uniform(0.0, 1.2 * N * dt))
        args = (pos, psi, dt, elapsed, 20.0, 2.5, 2.5)
        a = t_interp.interpolate_trajectory_by_elapsed_time(*args)
        b = j_interp.interpolate_trajectory_by_elapsed_time(*args)
        assert _equal(a, b), case
        n_none += a is None
    assert 0 < n_none < 150


def test_collision_mask_and_deviation_bit_equal_to_jax():
    rng = np.random.default_rng(1)
    for _ in range(50):
        n, m = rng.integers(0, 20, 2)
        a, b = rng.normal(0, 2, (n, 2)), rng.normal(0, 2, (m, 2))
        sigma = float(rng.uniform(0.2, 2.0))
        assert (t_interp.collision_mask_gk(a, b, sigma)
                == j_interp.collision_mask_gk(a, b, sigma))
        b2 = a + rng.normal(0, 0.5, a.shape)
        assert (t_interp.geometric_deviation(a, b2)
                == j_interp.geometric_deviation(a, b2))
        assert (t_interp.geometric_deviation(a, b)
                == j_interp.geometric_deviation(a, b))


def test_triggers_and_priorities_equal_to_jax():
    """500 seeded cycles of FSM state, solver outcome, topology, trajectory
    and time through both packages' ``decide_communication``, each with its
    own running state: the same decisions, reasons and counters; every
    reason occurs."""
    rng = np.random.default_rng(2)
    settings_t, settings_j = t_settings(), j_settings()
    n_paths = int(settings_t["JULES"]["n_paths"])
    states = [s.name for s in PS_T]
    comm_t, comm_j = t_comms.CommunicationState(), j_comms.CommunicationState()
    traj = np.zeros((10, 2))
    seen, now = set(), 0.0
    for _ in range(500):
        state = rng.choice(["PLANNING_ACTIVE"] * 6 + states)
        success = rng.uniform() > 0.15
        topo = int(rng.choice([0, 1, 2, 2 * n_paths]))
        changed = bool(rng.uniform() > 0.8)
        now += float(rng.uniform(0.0, 0.5))
        if rng.uniform() > 0.7:
            traj = traj + rng.normal(0.0, 1.0, traj.shape)
        outs = []
        for types_ in (t_types, j_types):
            out = types_.PlannerOutput()
            out.success, out.selected_topology_id = success, topo
            out.topology_changed = changed
            outs.append(out)
        sent = []
        for comms, types_, out, comm, settings in (
                (t_comms, t_types, outs[0], comm_t, settings_t),
                (j_comms, j_types, outs[1], comm_j, settings_j)):
            s = comms.decide_communication(
                types_.PlannerState[state], out, comm, settings, now, traj)
            if s:
                comm.last_send_time = now
                comm.last_communicated_trajectory = traj.copy()
                comm.n_sent += 1
            sent.append(s)
        assert sent[0] == sent[1]
        assert comm_t.trigger_reason.name == comm_j.trigger_reason.name
        assert (comm_t.n_sent, comm_t.n_cycles) == (comm_j.n_sent,
                                                    comm_j.n_cycles)
        seen.add(comm_t.trigger_reason.name)
    assert seen == {r.name for r in t_comms.CommunicationTriggerReason} - {
        "INFEASIBLE_TO_FEASIBLE"}


# ---------------------------------------------------------------------------
# Agents
# ---------------------------------------------------------------------------
def make_agent(pkg, ns, index, bus, clock, start, goal, N=15):
    """The JAX suite's robot (``tests/test_multirobot.py::make_agent``) in
    either package, on the CPU."""
    if pkg == "jax":
        settings_fn, fac, mr, sqp = j_settings, j_factory, j_mr, j_sqp
        kw = dict(dtype=jnp.float64)
    else:
        settings_fn, fac, mr, sqp = t_settings, t_factory, t_mr, t_sqp
        kw = dict(dtype=F64, device="cpu")
    settings = settings_fn(
        N=N, max_obstacles=2, weights={"goal": 5.0},
        guidance={"n_samples": 30, "longitudinal_goals": 2,
                  "vertical_goals": 3})
    model, modules = fac.configuration_goal_tmpc(settings)
    planner = fac.build_planner(model, modules, settings,
                                sqp_config=sqp.SQPConfig(**CFG),
                                clock=clock, **kw)
    return mr.RobotAgent(ns, index, planner, model, settings,
                         goal=np.asarray(goal, dtype=float), bus=bus,
                         clock=clock, start_pose=start)


def optimizer(agent):
    return next(m for m in agent.planner.modules
                if hasattr(m, "_optimizer"))._optimizer


HEAD_ON = [("jackal1", (2.0, 0.0, 0.0), (10.0, 0.0)),
           ("jackal2", (10.0, 1.2, np.pi), (2.0, 1.2))]


# ---------------------------------------------------------------------------
# (b) Lockstep drivers
# ---------------------------------------------------------------------------
def test_lockstep_drivers_host_decisions_equal():
    N, cycles = 8, 20
    ct, cj = FakeClock(), FakeClock()
    bt, bj = t_mr.MessageBus(), j_mr.MessageBus()
    ta = [make_agent("torch", ns, i, bt, ct, s, g, N=N)
          for i, (ns, s, g) in enumerate(HEAD_ON)]
    ja = [make_agent("jax", ns, i, bj, cj, s, g, N=N)
          for i, (ns, s, g) in enumerate(HEAD_ON)]
    plain = sqp_fused.make_fused_fleet_solver(
        ta[0].planner.solver.ocp, t_sqp.SQPConfig(**CFG), dtype=F64,
        device="cpu")
    box = [{} for _ in HEAD_ON]

    for r, (a_t, a_j) in enumerate(zip(ta, ja)):
        P = optimizer(a_t).n_planners

        def t_dispatch(params, xinit, warm, r=r):
            box[r]["in"] = (params.copy(), np.asarray(xinit).copy(),
                            warm.copy())

        def t_fetch(r=r, P=P):
            params, xinit, warm = box[r]["in"]
            box[r]["res"] = t_sqp.fetch_results(plain(
                params, torch.as_tensor(xinit)[None].expand(P, -1), warm))
            return box[r]["res"]

        def j_dispatch(params, xinit, warm, r=r):
            for got, want in zip((params, xinit, warm), box[r]["in"]):
                np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                                           atol=1e-12)
            box[r]["jax"] = True

        def j_fetch(r=r):
            assert box[r].pop("jax")
            return j_sqp.SQPResult(**box[r]["res"]._asdict())

        ot, oj = optimizer(a_t), optimizer(a_j)
        ot._dispatch_batch, ot._fetch_batch = t_dispatch, t_fetch
        oj._dispatch_batch, oj._fetch_batch = j_dispatch, j_fetch

    sent = {"torch": [], "jax": []}
    for name, bus in (("torch", bt), ("jax", bj)):
        publish = bus.publish

        def spy(sender, msg, _publish=publish, _name=name):
            sent[_name].append(msg)
            return _publish(sender, msg)

        bus.publish = spy
    dt_, dj = t_mr.MultiRobotDriver(ta, clock=ct), j_mr.MultiRobotDriver(
        ja, clock=cj)
    reasons, planned = set(), 0
    for cycle in range(cycles):
        lt, lj = dt_.run(1), dj.run(1)
        for a_t, a_j in zip(ta, ja):
            ctx = (cycle, a_t.ns)
            assert a_t.fsm.name == a_j.fsm.name, ctx
            assert a_t.comm.trigger_reason.name == a_j.comm.trigger_reason.name
            assert (a_t.comm.n_sent, a_t.comm.n_cycles) == (
                a_j.comm.n_sent, a_j.comm.n_cycles), ctx
            reasons.add(a_t.comm.trigger_reason.name)
            mt, mj = lt.records[a_t.ns][-1], lj.records[a_j.ns][-1]
            planned += mt.planner_state == "PLANNING_ACTIVE"
            for f in ("planner_state", "solver_success", "solver_exit_code",
                      "selected_topology_id", "selected_planner_index",
                      "used_guidance", "num_guidance_found",
                      "topology_changed", "communicated",
                      "communication_trigger"):
                assert getattr(mt, f) == getattr(mj, f), (ctx, f)
            np.testing.assert_allclose(a_t.last_command, a_j.last_command,
                                       rtol=0, atol=1e-10, err_msg=str(ctx))
            np.testing.assert_allclose(a_t.state.as_array(),
                                       a_j.state.as_array(), rtol=0,
                                       atol=1e-10, err_msg=str(ctx))
            obs_t = a_t.data.dynamic_obstacles
            obs_j = a_j.data.dynamic_obstacles
            assert len(obs_t) == len(obs_j)
            for o_t, o_j in zip(obs_t, obs_j):
                assert o_t.index == o_j.index
                np.testing.assert_allclose(o_t.position, o_j.position, rtol=0,
                                           atol=1e-10)
                pt = np.array([s.position for s in o_t.prediction.modes[0]])
                pj = np.array([s.position for s in o_j.prediction.modes[0]])
                np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-10)
        assert len(sent["torch"]) == len(sent["jax"])
        for m_t, m_j in zip(sent["torch"], sent["jax"]):
            for f in ("robot_ns", "robot_index", "radius", "dt", "stamp",
                      "is_braking"):
                assert getattr(m_t, f) == getattr(m_j, f), f
            assert m_t.trigger_reason.name == m_j.trigger_reason.name
            assert np.array_equal(m_t.positions, m_j.positions)
            assert np.array_equal(m_t.orientations, m_j.orientations)
    assert all(a.comm.n_sent > 0 for a in ta)
    assert planned >= cycles
    assert {"TIME", "NO_COMMUNICATION"} <= reasons


# ---------------------------------------------------------------------------
# (c) The port alone
# ---------------------------------------------------------------------------
def test_two_robot_head_on_exchange():
    """The JAX suite's head-on scene at N=12: both robots progress, they
    exchange trajectories, never collide, and communicate on fewer than 90%
    of their planning cycles."""
    clock, bus = FakeClock(), t_mr.MessageBus()
    a1, a2 = (make_agent("torch", ns, i, bus, clock, s, g, N=12)
              for i, (ns, s, g) in enumerate(HEAD_ON))
    log = t_mr.MultiRobotDriver([a1, a2], clock=clock).run(n_cycles=60)
    assert a1.state.get("x") > 7.0 and a2.state.get("x") < 5.0
    assert a1.comm.n_sent > 0 and a2.comm.n_sent > 0
    p1 = np.array([[m.position_x, m.position_y]
                   for m in log.records["jackal1"]])
    p2 = np.array([[m.position_x, m.position_y]
                   for m in log.records["jackal2"]])
    n = min(len(p1), len(p2))
    assert np.linalg.norm(p1[:n] - p2[:n], axis=1).min() > 2 * 0.325
    rate = log.communication_rate("jackal1")
    assert 0.0 < rate < 0.9


def test_fsm_startup_late_joiner_error_and_guard():
    """The FSM startup sequence; a late joiner pulls a peer's plan through
    the trajectory service and never waits for a push; a planner exception
    lands in ERROR_STATE with a zero command, invalid transitions are
    refused there, and recover() re-enters planning; an invalid request
    from TIMER_STARTUP lands in ERROR_STATE; a repeated request is a
    no-op."""
    clock, bus = FakeClock(), t_mr.MessageBus()
    a1 = make_agent("torch", "r1", 0, bus, clock, (2.0, 0.0, 0.0),
                    (8.0, 0.0), N=8)
    a1.set_peers(["r1", "r2"])
    states = []
    for _ in range(3):
        a1.tick()
        states.append(a1.fsm)
        clock.t += 0.2
    assert states == [PS_T.WAITING_FOR_FIRST_EGO_POSE,
                      PS_T.INITIALIZING_OBSTACLES,
                      PS_T.WAITING_FOR_TRAJECTORY_DATA]
    a1.set_peers(["r1"])
    for _ in range(2):
        a1.tick()
        clock.t += 0.2
    assert a1.fsm == PS_T.PLANNING_ACTIVE
    assert a1._last_trajectory_msg is not None

    a2 = make_agent("torch", "r2", 1, bus, clock, (8.0, 1.2, np.pi),
                    (2.0, 1.2), N=8)
    a1.set_peers(["r1", "r2"])
    a2.set_peers(["r1", "r2"])
    seen = []
    for _ in range(3):
        a2.tick()
        seen.append(a2.fsm)
        clock.t += 0.2
    assert PS_T.WAITING_FOR_TRAJECTORY_DATA not in seen
    assert seen[-1] == PS_T.PLANNING_ACTIVE
    np.testing.assert_array_equal(a2._peer_trajectories["r1"].positions,
                                  a1._last_trajectory_msg.positions)

    def boom(*a, **k):
        raise RuntimeError("injected solver crash")

    orig = a1.planner.solve_mpc
    a1.planner.solve_mpc = boom
    a1.tick()
    assert a1.fsm == PS_T.ERROR_STATE
    assert "injected solver crash" in a1.error_reason
    assert a1.last_command == (0.0, 0.0)
    a1.tick()
    assert a1.fsm == PS_T.ERROR_STATE
    assert not a1.transition_to(PS_T.PLANNING_ACTIVE)
    a1.planner.solve_mpc = orig
    a1.recover()
    assert a1.fsm == PS_T.RESETTING
    for _ in range(6):
        a1.tick()
        a2.tick()
        clock.t += 0.2
    assert a1.fsm == PS_T.PLANNING_ACTIVE, a1.fsm

    a3 = make_agent("torch", "r3", 2, t_mr.MessageBus(), clock,
                    (0.0, 0.0, 0.0), (5.0, 0.0), N=8)
    assert not a3.transition_to(PS_T.GOAL_REACHED)
    assert a3.fsm == PS_T.ERROR_STATE
    assert a3.previous_fsm == PS_T.TIMER_STARTUP
    assert "TIMER_STARTUP -> GOAL_REACHED" in a3.error_reason
    a4 = make_agent("torch", "r4", 3, t_mr.MessageBus(), clock,
                    (0.0, 0.0, 0.0), (5.0, 0.0), N=8)
    for s in (PS_T.WAITING_FOR_FIRST_EGO_POSE, PS_T.INITIALIZING_OBSTACLES,
              PS_T.PLANNING_ACTIVE, PS_T.PLANNING_ACTIVE):
        assert a4.transition_to(s)
    assert a4.fsm == PS_T.PLANNING_ACTIVE and a4.error_reason == ""


def test_desynchronized_experiments(tmp_path):
    """``run_experiments`` over the desynchronized driver (two robots, N=8,
    two episodes of 12 periods): episode segmentation in ``ExperimentUtil``,
    the export into ``tmp_path``, schedules that are not lockstep and tick
    intervals that are jittered, and no collision."""
    from oscar_mpc_planner_mr_modification_tpu_torch.utils.datasaver import (
        ExperimentUtil)

    clock, bus = FakeClock(), t_mr.MessageBus()
    a1 = make_agent("torch", "r1", 0, bus, clock, (2.0, 0.0, 0.0),
                    (8.0, 0.0), N=8)
    a2 = make_agent("torch", "r2", 1, bus, clock, (8.0, 1.4, np.pi),
                    (2.0, 1.4), N=8)
    exp = ExperimentUtil({"recording": {
        "enable": True, "folder": str(tmp_path), "timestamp": False,
        "num_experiments": 2}})
    driver = t_mr.MultiRobotDriver([a1, a2], clock=clock, experiment_util=exp)
    log = driver.run_experiments(n_episodes=2, n_cycles=12,
                                 desynchronized=True, jitter=0.35, seed=3)
    summary = exp.summary()
    assert summary["experiments"] == 2 and summary["total_collisions"] == 0
    assert summary["mean_duration"] > 0.5
    assert set(exp.saver.get("experiment")) == {0, 1}
    assert (tmp_path / "experiment.json").exists()
    t1 = sorted(m.stamp for m in log.records["r1"])
    t2 = sorted(m.stamp for m in log.records["r2"])
    s1, s2 = set(np.round(t1, 6)), set(np.round(t2, 6))
    assert len(s1 & s2) < 0.8 * min(len(s1), len(s2))
    iv1 = np.diff(t1)
    assert np.std(iv1[iv1 > 1e-9]) > 0.01
    assert any(m.planner_state == "PLANNING_ACTIVE" and m.solver_success
               for m in log.records["r1"])
