"""The port's socket transport (``multirobot/transport.py``) against the JAX
package's, on the CPU.

- The wire format is the JAX package's byte for byte: the same seeded
  message encodes to the same bytes in both packages, and each package
  decodes the other's bytes to the same fields (exact).
- The port's broker: pub/sub (a broadcast reaches the other clients, never
  its sender), latched first poses and sync barrier replayed to a late
  joiner, the trajectory-pull service.
- One JAX ``SocketBus`` client and one port client exchange messages both
  ways through a port ``TransportBroker``, and the JAX client's service
  answers the port client's request.

The JAX suite's case with robots in separate OS processes is not repeated
here: each process compiles its own planner, which takes longer than this
file's budget on the CPU.
"""

import time

import numpy as np
import pytest

from oscar_mpc_planner_mr_modification_tpu.multirobot import comms as j_comms
from oscar_mpc_planner_mr_modification_tpu.multirobot import (
    transport as j_transport)
from oscar_mpc_planner_mr_modification_tpu_torch.multirobot import (
    comms as t_comms)
from oscar_mpc_planner_mr_modification_tpu_torch.multirobot import (
    transport as t_transport)


def _msg(comms, ns="r1", n=7, stamp=123.456, braking=False, seed=0,
         reason="GEOMETRIC"):
    rng = np.random.default_rng(seed)
    return comms.TrajectoryMessage(
        robot_ns=ns, robot_index=3, positions=rng.standard_normal((n, 2)),
        orientations=rng.standard_normal(n), radius=0.325, dt=0.05,
        stamp=stamp, trigger_reason=comms.CommunicationTriggerReason[reason],
        is_braking=braking)


def _same(a, b):
    assert (a.robot_ns, a.robot_index, a.radius, a.dt, a.stamp,
            a.is_braking) == (b.robot_ns, b.robot_index, b.radius, b.dt,
                              b.stamp, b.is_braking)
    assert a.trigger_reason.name == b.trigger_reason.name
    assert np.array_equal(a.positions, b.positions)
    assert np.array_equal(a.orientations, b.orientations)


@pytest.mark.parametrize("case", range(6))
def test_wire_format_equal_to_jax(case):
    """Seeded messages of 0-30 poses, every trigger reason, braking or not,
    a namespace with non-ASCII characters: equal bytes, and each package
    decodes the other's."""
    reasons = [r.name for r in t_comms.CommunicationTriggerReason]
    kw = dict(ns=["r1", "jackal_2", "röbot-3", "a" * 40, "", "r6"][case],
              n=[7, 0, 1, 30, 12, 3][case], stamp=123.456 + case,
              braking=bool(case % 2), seed=case,
              reason=reasons[case % len(reasons)])
    mt, mj = _msg(t_comms, **kw), _msg(j_comms, **kw)
    bt, bj = t_transport.encode_trajectory(mt), j_transport.encode_trajectory(
        mj)
    assert bt == bj
    _same(t_transport.decode_trajectory(bj), mj)
    _same(j_transport.decode_trajectory(bt), mt)
    _same(t_transport.decode_trajectory(bt), mt)


def _wait_for(pred, timeout=5.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.01)
    return False


def test_broker_pubsub_latch_and_service():
    broker = t_transport.TransportBroker()
    try:
        b1 = t_transport.SocketBus("r1", broker.address, service_timeout=1.0)
        b2 = t_transport.SocketBus("r2", broker.address, service_timeout=1.0)
        got1, got2 = [], []
        b1.subscribe("r1", got1.append)
        b2.subscribe("r2", got2.append)
        b1.publish("r1", _msg(t_comms, "r1"))
        assert _wait_for(lambda: len(got2) == 1)
        _same(got2[0], _msg(t_comms, "r1"))
        assert not got1
        b1.first_poses["r1"] = np.array([1.0, 2.0])
        b1.sync_ready.add("r1")
        assert _wait_for(lambda: "r1" in b2.first_poses
                         and "r1" in b2.sync_ready)
        np.testing.assert_array_equal(b2.first_poses["r1"], [1.0, 2.0])
        b3 = t_transport.SocketBus("r3", broker.address, service_timeout=1.0)
        assert _wait_for(lambda: "r1" in b3.first_poses
                         and "r1" in b3.sync_ready)
        b1.register_trajectory_service(
            "r1", lambda req, pose: _msg(t_comms, "r1", stamp=1.0))
        b2.register_trajectory_service(
            "r2", lambda req, pose: _msg(t_comms, "r2", stamp=2.0))
        replies = b3.request_trajectories("r3", np.zeros(2))
        assert sorted(m.robot_ns for m in replies) == ["r1", "r2"]
        b1.first_poses.pop("r1")
        b1.sync_ready.discard("r1")
        assert _wait_for(lambda: "r1" not in b3.first_poses
                         and "r1" not in b3.sync_ready)
        for b in (b1, b2, b3):
            b.close()
    finally:
        broker.close()


def test_jax_and_port_clients_share_a_port_broker():
    """A JAX robot's bus and a port robot's bus on one port broker: each
    receives the other's broadcast, decoded into its own package's message
    with the same fields, and the port client pulls the JAX client's plan
    through the trajectory service."""
    broker = t_transport.TransportBroker()
    try:
        bj = j_transport.SocketBus("jax_robot", broker.address,
                                   service_timeout=1.0)
        bt = t_transport.SocketBus("port_robot", broker.address,
                                   service_timeout=1.0)
        got_j, got_t = [], []
        bj.subscribe("jax_robot", got_j.append)
        bt.subscribe("port_robot", got_t.append)
        mj = _msg(j_comms, "jax_robot", seed=4, reason="TOPOLOGY_CHANGE")
        mt = _msg(t_comms, "port_robot", seed=5, braking=True,
                  reason="INFEASIBLE")
        bj.publish("jax_robot", mj)
        bt.publish("port_robot", mt)
        assert _wait_for(lambda: got_j and got_t)
        assert isinstance(got_t[0], t_comms.TrajectoryMessage)
        assert isinstance(got_j[0], j_comms.TrajectoryMessage)
        _same(got_t[0], mj)
        _same(got_j[0], mt)
        bj.register_trajectory_service("jax_robot", lambda req, pose: mj)
        replies = bt.request_trajectories("port_robot", np.zeros(2))
        assert len(replies) == 1
        _same(replies[0], mj)
        bj.close()
        bt.close()
    finally:
        broker.close()
