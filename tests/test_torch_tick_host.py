"""Host layers of the planner tick: the port against the JAX package, exactly.

The same numpy scenes go through each package's data preparation, state,
roadmap, pedestrian simulator and guidance PRM (numpy and C++ backends, the
port building its own copy of ``native/prm.cpp``). These are host numpy or
the same C++ source, so they must agree bit for bit; where a float sum may
run in another order the tolerance is 1e-12.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from oscar_mpc_planner_mr_modification_tpu.guidance import (  # noqa: E402
    cpp_backend as j_cpp, global_guidance as j_gg, homotopy as j_hom)
from oscar_mpc_planner_mr_modification_tpu.models import (  # noqa: E402
    ContouringSecondOrderUnicycleModel as JModel)
from oscar_mpc_planner_mr_modification_tpu.planner import (  # noqa: E402
    data_preparation as j_dp)
from oscar_mpc_planner_mr_modification_tpu.sim import (  # noqa: E402
    pedestrians as j_ped, roadmap as j_road)
from oscar_mpc_planner_mr_modification_tpu.solver import (  # noqa: E402
    State as JState)
from oscar_mpc_planner_mr_modification_tpu import types as j_types  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.guidance import (  # noqa: E402
    cpp_backend as t_cpp, global_guidance as t_gg, homotopy as t_hom)
from oscar_mpc_planner_mr_modification_tpu_torch.models import (  # noqa: E402
    ContouringSecondOrderUnicycleModel as TModel)
from oscar_mpc_planner_mr_modification_tpu_torch.planner import (  # noqa: E402
    data_preparation as t_dp)
from oscar_mpc_planner_mr_modification_tpu_torch.sim import (  # noqa: E402
    pedestrians as t_ped, roadmap as t_road)
from oscar_mpc_planner_mr_modification_tpu_torch.solver import (  # noqa: E402
    State as TState)
from oscar_mpc_planner_mr_modification_tpu_torch import types as t_types  # noqa: E402

N, DT = 12, 0.2


def states(x, y, psi, v, s=0.0):
    out = []
    for cls, model in ((JState, JModel()), (TState, TModel())):
        st = cls(model)
        for name, val in zip(("x", "y", "psi", "v", "spline"),
                             (x, y, psi, v, s)):
            st.set(name, val)
        out.append(st)
    return out


def obstacle_lists(specs, probabilistic=False):
    """The same obstacles built by each package: (position, velocity,
    radius) per obstacle."""
    out = []
    for dp, types in ((j_dp, j_types), (t_dp, t_types)):
        obs = []
        for i, (pos, vel, r) in enumerate(specs):
            o = types.DynamicObstacle(index=i, position=np.asarray(pos, float),
                                      radius=r)
            o.prediction = dp.get_constant_velocity_prediction(
                pos, vel, DT, N, probabilistic)
            obs.append(o)
        out.append(obs)
    return out


def same_obstacles(a, b):
    assert len(a) == len(b)
    for oa, ob in zip(a, b):
        assert oa.index == ob.index and oa.radius == ob.radius
        np.testing.assert_array_equal(oa.position, ob.position)
        assert oa.prediction.type.name == ob.prediction.type.name
        assert len(oa.prediction.modes) == len(ob.prediction.modes)
        for ma, mb in zip(oa.prediction.modes, ob.prediction.modes):
            assert len(ma) == len(mb)
            np.testing.assert_array_equal(
                np.array([s.position for s in ma]).reshape(-1, 2),
                np.array([s.position for s in mb]).reshape(-1, 2))
            np.testing.assert_array_equal(
                [(s.angle, s.major_radius, s.minor_radius) for s in ma],
                [(s.angle, s.major_radius, s.minor_radius) for s in mb])


# ---------------------------------------------------------------------------
# Data preparation, state, roadmap, pedestrians
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_discs", [1, 2, 3])
def test_define_robot_area(n_discs):
    a = j_dp.define_robot_area(1.2, 0.6, n_discs)
    b = t_dp.define_robot_area(1.2, 0.6, n_discs)
    assert [(d.offset, d.radius) for d in a] == [(d.offset, d.radius) for d in b]
    pos = np.array([1.0, -2.0])
    for da, db in zip(a, b):
        np.testing.assert_array_equal(da.get_position(pos, 0.3),
                                      db.get_position(pos, 0.3))


@pytest.mark.parametrize("probabilistic", [False, True])
def test_predictions(probabilistic):
    rng = np.random.default_rng(3)
    specs = [(rng.normal(size=2) * 4, rng.normal(size=2), 0.3)
             for _ in range(3)]
    a, b = obstacle_lists(specs, probabilistic)
    same_obstacles(a, b)
    for oa, ob in zip(a, b):
        np.testing.assert_array_equal(oa.prediction.mode_positions(0),
                                      ob.prediction.mode_positions(0))
    ga = j_dp.get_gmm_prediction([1.0, 2.0], [[1.0, 0.0], [0.0, -1.0]],
                                 [0.7, 0.3], DT, N, noise=0.2)
    gb = t_dp.get_gmm_prediction([1.0, 2.0], [[1.0, 0.0], [0.0, -1.0]],
                                 [0.7, 0.3], DT, N, noise=0.2)
    for ma, mb in zip(ga.modes, gb.modes):
        assert [(s.major_radius, s.minor_radius) for s in ma] == [
            (s.major_radius, s.minor_radius) for s in mb]


def test_mode_positions_fresh_and_empty():
    """The port's repaired ``mode_positions``: a fresh (L, 2) array, (0, 2)
    for an empty mode."""
    ob = obstacle_lists([((1.0, 1.0), (0.5, 0.0), 0.3)])[1][0]
    mp = ob.prediction.mode_positions(0)
    mp[0] = 99.0
    assert ob.prediction.modes[0][0].position[0] != 99.0
    ob.prediction.modes[0] = []
    assert ob.prediction.mode_positions(0).shape == (0, 2)


@pytest.mark.parametrize("n_obs", [1, 2, 5])
def test_ensure_obstacle_size(n_obs):
    """Fewer obstacles than ``max_obstacles`` are padded with dummies, more
    are cut to the closest by the time-scaled distance, and re-indexed."""
    rng = np.random.default_rng(n_obs)
    specs = [(rng.uniform(-6, 6, 2), rng.normal(size=2), 0.3)
             for _ in range(n_obs)]
    sa, sb = states(0.5, -0.2, 0.4, 1.1)
    a, b = obstacle_lists(specs)
    a = j_dp.ensure_obstacle_size(a, sa, 3, N, DT)
    b = t_dp.ensure_obstacle_size(b, sb, 3, N, DT)
    assert len(b) == 3
    same_obstacles(a, b)
    a2, b2 = obstacle_lists(specs)
    same_obstacles(j_dp.remove_distant_obstacles(a2, sa, 4.0),
                   t_dp.remove_distant_obstacles(b2, sb, 4.0))


def test_state_round_trip():
    sa, sb = states(1.5, -0.5, 0.3, 0.9, 2.5)
    np.testing.assert_array_equal(sa.as_array(), sb.as_array())
    x = np.array([3.0, 1.0, -0.2, 1.4, 7.5])
    sa.set_array(x)
    sb.set_array(x)
    for name in ("x", "y", "psi", "v", "spline"):
        assert sa.get(name) == sb.get(name)
    np.testing.assert_array_equal(sa.get_position(), sb.get_position())
    assert sa.valid_data() == sb.valid_data() is True
    sb.reset()
    assert not sb.valid_data() and sb.has("spline") and not sb.has("a")


def test_roadmap_paths():
    pairs = [(j_road.straight_path(65.0), t_road.straight_path(65.0)),
             (j_road.curve_path(8.0), t_road.curve_path(8.0)),
             (j_road.s_bend_path(velocity=1.5), t_road.s_bend_path(velocity=1.5))]
    pairs += list(zip(j_road.path_with_bounds(pairs[2][0]),
                      t_road.path_with_bounds(pairs[2][1])))
    for a, b in pairs:
        for f in ("x", "y", "psi", "v", "s"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_pedestrian_simulator_20_steps():
    rng = np.random.default_rng(7)
    starts = rng.uniform(-4, 4, (5, 2))
    goals = rng.uniform(-4, 4, (5, 2))
    sims = [mod.PedestrianSimulator(
        [mod.Pedestrian(s.copy(), g.copy()) for s, g in zip(starts, goals)],
        dt=DT, process_noise=0.3, seed=11) for mod in (j_ped, t_ped)]
    robot = np.array([0.0, 0.0])
    for _ in range(20):
        for sim in sims:
            sim.step([robot])
        robot = robot + np.array([0.2, 0.0])
        for pa, pb in zip(*(s.pedestrians for s in sims)):
            np.testing.assert_array_equal(pa.position, pb.position)
            np.testing.assert_array_equal(pa.velocity, pb.velocity)
    same_obstacles(sims[0].get_obstacles(N), sims[1].get_obstacles(N))


# ---------------------------------------------------------------------------
# Guidance PRM
# ---------------------------------------------------------------------------
NG = 20  # the guidance horizon of these scenes


def make_guidance(mod, backend, comparison):
    cfg = mod.GuidanceConfig(N=NG, dt=DT, n_paths=4, n_samples=40, seed=1,
                             comparison_function=comparison)
    gg = mod.GlobalGuidance(cfg, backend=backend)
    gg.set_start(np.zeros(2), 0.0, 1.0)
    gg.set_goals([mod.Goal(np.array([6.0, y]), abs(y))
                  for y in (0.0, 1.5, -1.5)])
    return gg


def load_scene(gg, t):
    """An obstacle in the corridor and one crossing it, at cycle ``t``."""
    base = np.array([[3.0, 0.0], [5.0, 2.5]])
    vel = np.array([[0.0, 0.0], [0.0, -0.3]])
    k = np.arange(NG + 1)[None, :, None] * DT
    gg.load_obstacles(base[:, None] + vel[:, None] * (k + t * DT),
                      np.array([0.8, 0.5]))


@pytest.mark.parametrize("backend", ["python", "cpp"])
@pytest.mark.parametrize("comparison", ["Winding", "Homology"])
def test_global_guidance_parity(backend, comparison):
    """Trajectories, topology classes, classification of a path and the
    stickiness of the selected class, over 4 cycles."""
    ja = make_guidance(j_gg, backend, comparison)
    tb = make_guidance(t_gg, backend, comparison)
    most = 0
    for cycle in range(4):
        for gg in (ja, tb):
            load_scene(gg, cycle)
            gg.set_start(np.array([0.2 * cycle, 0.0]), 0.0, 1.0)
        ok_a, ok_b = ja.update(), tb.update()
        assert ok_a == ok_b
        assert tb.ran_backend == backend
        assert ja.number_of_guidance_trajectories() == \
            tb.number_of_guidance_trajectories() >= 1
        most = max(most, tb.number_of_guidance_trajectories())
        for a, b in zip(ja.trajectories, tb.trajectories):
            np.testing.assert_array_equal(a.positions, b.positions)
            np.testing.assert_array_equal(a.velocities, b.velocities)
            np.testing.assert_allclose(a.signature, b.signature, rtol=0,
                                       atol=1e-12)
            assert (a.topology_class, a.cost, a.previously_selected,
                    a.color) == (b.topology_class, b.cost,
                                 b.previously_selected, b.color)
        # classification of a perturbed guidance path and of a far one
        probe = tb.trajectories[-1].positions + 0.05
        far = np.stack([np.linspace(0, 6, NG + 1), np.full(NG + 1, 9.0)], 1)
        for path in (probe, far):
            assert (ja.find_topology_class_for_path(path)
                    == tb.find_topology_class_for_path(path))
        # select one class; it must come first and keep its id next cycle
        pick = tb.trajectories[min(cycle, len(tb.trajectories) - 1)]
        for gg in (ja, tb):
            gg.override_selected_trajectory(pick.topology_class, clear=False,
                                            selected_path=pick.positions)
        if cycle:
            first = tb.trajectories[0]
            assert first.previously_selected == ja.trajectories[0].previously_selected
    assert most >= 2
    np.testing.assert_array_equal(ja._selected_path, tb._selected_path)
    assert ja._selected_class == tb._selected_class
    for gg in (ja, tb):
        gg.override_selected_trajectory(-1, clear=True)
    assert tb._selected_class == -1 and tb._selected_path is None


def test_selected_class_is_sticky():
    """The port alone: after selecting a class, the next update lists it
    first, flagged, under the same id."""
    gg = make_guidance(t_gg, "cpp", "Homology")
    load_scene(gg, 0)
    assert gg.update() and gg.number_of_guidance_trajectories() >= 2
    t0 = gg.get_guidance_trajectory(1)
    gg.override_selected_trajectory(t0.topology_class, clear=False)
    load_scene(gg, 1)
    gg.update()
    assert gg.get_guidance_trajectory(0).previously_selected
    assert gg.get_guidance_trajectory(0).topology_class == t0.topology_class


def test_homotopy_signatures():
    rng = np.random.default_rng(2)
    paths = np.cumsum(rng.normal(scale=0.3, size=(6, N + 1, 2)), axis=1)
    obs = rng.uniform(-2, 2, (3, N + 1, 2))
    np.testing.assert_array_equal(j_hom.signature_batch(paths, obs),
                                  t_hom.signature_batch(paths, obs))
    np.testing.assert_array_equal(
        j_hom.h_signature_batch_numpy(paths, obs, DT),
        t_hom.h_signature_batch_numpy(paths, obs, DT))
    native = t_cpp.h_signature_batch(paths, obs, DT)
    np.testing.assert_array_equal(native,
                                  j_cpp.h_signature_batch(paths, obs, DT))
    np.testing.assert_allclose(native,
                               t_hom.h_signature_batch_numpy(paths, obs, DT),
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("backend", ["python", "cpp", "auto"])
def test_signature_backend_is_chosen_once_and_recorded(backend):
    """The H-signature classifier runs the implementation the guidance
    object records, the native one whenever the library builds (the JAX
    package's choice); winding signatures are numpy. The module function
    takes its implementation by name and switches to no other."""
    rng = np.random.default_rng(3)
    paths = np.cumsum(rng.normal(scale=0.3, size=(4, NG + 1, 2)), axis=1)
    obs = rng.uniform(-2, 2, (2, NG + 1, 2))
    homology = make_guidance(t_gg, backend, "Homology")
    assert homology.signature_backend == "cpp"
    np.testing.assert_array_equal(homology._signature_batch(paths, obs),
                                  t_cpp.h_signature_batch(paths, obs, DT))
    assert make_guidance(t_gg, backend, "Winding").signature_backend == "python"
    np.testing.assert_array_equal(
        t_hom.h_signature_batch(paths, obs, DT, backend="python"),
        t_hom.h_signature_batch_numpy(paths, obs, DT))
    np.testing.assert_array_equal(t_hom.h_signature_batch(paths, obs, DT),
                                  t_cpp.h_signature_batch(paths, obs, DT))
    with pytest.raises(ValueError, match="neither"):
        t_hom.h_signature_batch(paths, obs, DT, backend="auto")
    with pytest.raises(ValueError, match="unknown guidance backend"):
        t_gg.GlobalGuidance(backend="numpy")


def test_prm_library_is_the_ports_own():
    """The port builds its own copy of the PRM source into build/prm/, named
    by the source hash, and never the JAX package's library path."""
    assert t_cpp.available()
    path = t_cpp.library_path()
    assert path.parent.name == "prm" and path.parent.parent.name == "build"
    assert path.is_file()
    assert t_cpp._SRC.read_bytes() != b""
    assert "oscar_mpc_planner_mr_modification_tpu_torch" in str(t_cpp._SRC)
