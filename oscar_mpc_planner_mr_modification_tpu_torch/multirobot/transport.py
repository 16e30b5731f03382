"""Cross-process robot-to-robot transport, counterpart of the JAX package's
``multirobot/transport.py``.

The in-process :class:`~.driver.MessageBus` serves a single-process
simulation; this module offers the same interface over sockets, so that
robots in separate OS processes (true asynchrony, serialization and
staleness) run :class:`~.driver.RobotAgent` unchanged. One
:class:`TransportBroker` relays framed messages between :class:`SocketBus`
clients and replays latched state (first poses, the sync barrier) to late
joiners. Trajectories travel in an explicit packed binary codec
(:func:`encode_trajectory` / :func:`decode_trajectory`), byte for byte the
JAX package's, so robots of both packages can share one broker.

Wire framing: 4-byte big-endian length, 1-byte type tag, payload.
"""

from __future__ import annotations

import socket
import struct
import threading

import uuid
from typing import Callable, Dict, List, Optional

import numpy as np

from .comms import CommunicationTriggerReason, TrajectoryMessage

# Message type tags
_HELLO = 1        # ns registration
_TRAJ = 2         # TrajectoryMessage broadcast
_FIRST_POSE = 3   # latched first pose announce / remove
_SYNC = 4         # sync barrier add / remove
_SRV_REQ = 5      # trajectory service request (fan-out)
_SRV_RESP = 6     # trajectory service response (routed to requester)
_ACK = 7          # broker -> client: HELLO processed, client registered


def _pack_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">H", len(b)) + b


def _unpack_str(buf: bytes, off: int):
    (n,) = struct.unpack_from(">H", buf, off)
    off += 2
    return buf[off:off + n].decode(), off + n


def encode_trajectory(msg: TrajectoryMessage) -> bytes:
    """ObstacleGMM-equivalent wire format: header + f64 pose arrays."""
    pos = np.ascontiguousarray(msg.positions, dtype=np.float64)
    ori = np.ascontiguousarray(msg.orientations, dtype=np.float64)
    head = (_pack_str(msg.robot_ns)
            + struct.pack(">idddBBi", msg.robot_index, msg.radius, msg.dt,
                          msg.stamp, msg.trigger_reason.value,
                          1 if msg.is_braking else 0, pos.shape[0]))
    return head + pos.tobytes() + ori.tobytes()


def decode_trajectory(buf: bytes) -> TrajectoryMessage:
    ns, off = _unpack_str(buf, 0)
    idx, radius, dt, stamp, reason, braking, n = struct.unpack_from(
        ">idddBBi", buf, off)
    off += struct.calcsize(">idddBBi")
    pos = np.frombuffer(buf, dtype=np.float64, count=2 * n,
                        offset=off).reshape(n, 2).copy()
    off += 16 * n
    ori = np.frombuffer(buf, dtype=np.float64, count=n, offset=off).copy()
    return TrajectoryMessage(
        robot_ns=ns, robot_index=idx, positions=pos, orientations=ori,
        radius=radius, dt=dt, stamp=stamp,
        trigger_reason=CommunicationTriggerReason(reason),
        is_braking=bool(braking))


def _send_frame(sock: socket.socket, tag: int, payload: bytes) -> None:
    sock.sendall(struct.pack(">IB", len(payload) + 1, tag) + payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket):
    head = _recv_exact(sock, 5)
    if head is None:
        return None, None
    (length, tag) = struct.unpack(">IB", head)
    payload = _recv_exact(sock, length - 1)
    if payload is None and length > 1:
        return None, None
    return tag, payload or b""


class TransportBroker:
    """roscore-analog relay: accepts :class:`SocketBus` clients, fans out
    trajectory broadcasts to every OTHER client, latches first-pose/sync
    state for late joiners, and routes service requests/responses.

    ``delay``: seconds of artificial one-way latency added to every relayed
    message (applied off-thread; ordering per connection is preserved by a
    single delay worker). Lets tests measure trigger/staleness behavior
    under WAN-like conditions without touching the host network stack."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 delay: float = 0.0):
        self.delay = float(delay)
        self._delayq = None
        if self.delay > 0.0:
            import queue

            self._delayq = queue.Queue()
            t = threading.Thread(target=self._delay_loop, daemon=True)
            t.start()
        self._srv = socket.create_server((host, port))
        self.address = self._srv.getsockname()
        self._clients: Dict[str, socket.socket] = {}
        self._latched: List[tuple] = []  # (tag, payload) replayed to joiners
        self._lock = threading.Lock()
        self._running = True
        self._threads: List[threading.Thread] = []
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            t = threading.Thread(target=self._client_loop, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _client_loop(self, conn: socket.socket) -> None:
        tag, payload = _recv_frame(conn)
        if tag != _HELLO:
            conn.close()
            return
        ns, _ = _unpack_str(payload, 0)
        with self._lock:
            self._clients[ns] = conn
            for ltag, lpayload in self._latched:
                _send_frame(conn, ltag, lpayload)
            # Registration ACK: a client that has not seen this may publish
            # before its peers are registered and the fanout silently drops
            # the message (the ROS publisher/subscriber startup race).
            # SocketBus.__init__ blocks on it, so "constructed" means
            # "receiving" for every later sender.
            _send_frame(conn, _ACK, b"")
        try:
            while self._running:
                tag, payload = _recv_frame(conn)
                if tag is None:
                    break
                if tag == _TRAJ:
                    self._fanout(tag, payload, exclude=ns)
                elif tag in (_FIRST_POSE, _SYNC):
                    with self._lock:
                        self._latched.append((tag, payload))
                    self._fanout(tag, payload, exclude=None)
                elif tag == _SRV_REQ:
                    self._fanout(tag, payload, exclude=ns)
                elif tag == _SRV_RESP:
                    target, _ = _unpack_str(payload, 0)
                    with self._lock:
                        sock = self._clients.get(target)
                    if sock is not None:
                        self._send(sock, tag, payload)
        finally:
            with self._lock:
                if self._clients.get(ns) is conn:
                    del self._clients[ns]
            conn.close()

    def _delay_loop(self) -> None:
        import time as _time

        while True:
            due, sock, tag, payload = self._delayq.get()
            wait = due - _time.monotonic()
            if wait > 0:
                _time.sleep(wait)
            try:
                _send_frame(sock, tag, payload)
            except OSError:
                pass

    def _send(self, sock: socket.socket, tag: int, payload: bytes) -> None:
        if self._delayq is not None:
            import time as _time

            self._delayq.put((_time.monotonic() + self.delay, sock, tag,
                              payload))
            return
        try:
            _send_frame(sock, tag, payload)
        except OSError:
            pass

    def _fanout(self, tag: int, payload: bytes, exclude: Optional[str]
                ) -> None:
        with self._lock:
            socks = [(n, s) for n, s in self._clients.items() if n != exclude]
        for _, s in socks:
            self._send(s, tag, payload)

    def close(self) -> None:
        self._running = False
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            for s in self._clients.values():
                try:
                    s.close()
                except OSError:
                    pass
            self._clients.clear()


class _MirroredPoses(dict):
    """``bus.first_poses`` view: writes announce over the wire, reads hit the
    local mirror (eventually consistent, like a latched topic)."""

    def __init__(self, bus: "SocketBus"):
        super().__init__()
        self._bus = bus

    def __setitem__(self, ns: str, pose) -> None:
        pose = np.asarray(pose, dtype=np.float64)
        super().__setitem__(ns, pose)
        self._bus._send(_FIRST_POSE,
                        _pack_str(ns) + b"\x01" + pose[:2].tobytes())

    def pop(self, ns, default=None):
        out = super().pop(ns, default)
        self._bus._send(_FIRST_POSE, _pack_str(ns) + b"\x00")
        return out


class _MirroredSync(set):
    """``bus.sync_ready`` view with wire-announced add/discard."""

    def __init__(self, bus: "SocketBus"):
        super().__init__()
        self._bus = bus

    def add(self, ns: str) -> None:
        super().add(ns)
        self._bus._send(_SYNC, _pack_str(ns) + b"\x01")

    def discard(self, ns: str) -> None:
        super().discard(ns)
        self._bus._send(_SYNC, _pack_str(ns) + b"\x00")


class SocketBus:
    """Drop-in :class:`~.driver.MessageBus` over a broker socket.

    One instance per robot PROCESS. The subscribe/publish/service surface is
    identical to the in-process bus; ``request_trajectories`` performs a real
    blocking request/collect with ``service_timeout`` seconds to gather peer
    responses (peers that don't answer in time are simply absent — the
    late-joiner path tolerates that, driver.py:304-309)."""

    def __init__(self, ns: str, address, service_timeout: float = 0.5):
        self.ns = ns
        self.service_timeout = service_timeout
        self._sock = socket.create_connection(tuple(address))
        self._subscribers: List[Callable] = []
        self._service: Optional[Callable] = None
        self.first_poses = _MirroredPoses(self)
        self.sync_ready = _MirroredSync(self)
        self._pending: Dict[str, List[TrajectoryMessage]] = {}
        self._pending_expected: Dict[str, int] = {}
        self._pending_done: Dict[str, threading.Event] = {}
        self._lock = threading.Lock()
        self._running = True
        self._registered = threading.Event()
        _send_frame(self._sock, _HELLO, _pack_str(ns))
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()
        if not self._registered.wait(5.0):
            raise TimeoutError(f"broker did not acknowledge HELLO for {ns!r}")

    # -- MessageBus interface ---------------------------------------------
    def subscribe(self, ns: str, callback: Callable) -> None:
        assert ns == self.ns, "a SocketBus carries exactly one robot"
        self._subscribers.append(callback)

    def publish(self, sender_ns: str, msg: TrajectoryMessage) -> None:
        self._send(_TRAJ, encode_trajectory(msg))

    def register_trajectory_service(self, ns: str, handler: Callable) -> None:
        assert ns == self.ns
        self._service = handler

    def request_trajectories(self, requesting_ns: str, requesting_pose
                             ) -> List[TrajectoryMessage]:
        req_id = uuid.uuid4().hex
        ev = threading.Event()
        with self._lock:
            self._pending[req_id] = []
            self._pending_done[req_id] = ev
        pose = np.asarray(requesting_pose, dtype=np.float64)
        self._send(_SRV_REQ, _pack_str(requesting_ns) + _pack_str(req_id)
                   + pose[:2].tobytes())
        ev.wait(self.service_timeout)
        with self._lock:
            self._pending_done.pop(req_id, None)
            return self._pending.pop(req_id, [])

    # -- wire -------------------------------------------------------------
    def _send(self, tag: int, payload: bytes) -> None:
        try:
            _send_frame(self._sock, tag, payload)
        except OSError:
            pass

    def _read_loop(self) -> None:
        while self._running:
            try:
                tag, payload = _recv_frame(self._sock)
            except OSError:
                return
            if tag is None:
                return
            if tag == _ACK:
                self._registered.set()
            elif tag == _TRAJ:
                msg = decode_trajectory(payload)
                if msg.robot_ns == self.ns:
                    continue
                for cb in self._subscribers:
                    cb(msg)
            elif tag == _FIRST_POSE:
                ns, off = _unpack_str(payload, 0)
                if payload[off] == 1:
                    pose = np.frombuffer(payload, np.float64, 2, off + 1)
                    dict.__setitem__(self.first_poses, ns, pose.copy())
                else:
                    dict.pop(self.first_poses, ns, None)
            elif tag == _SYNC:
                ns, off = _unpack_str(payload, 0)
                if payload[off] == 1:
                    set.add(self.sync_ready, ns)
                else:
                    set.discard(self.sync_ready, ns)
            elif tag == _SRV_REQ:
                requester, off = _unpack_str(payload, 0)
                req_id, off = _unpack_str(payload, off)
                pose = np.frombuffer(payload, np.float64, 2, off).copy()
                reply = (self._service(requester, pose)
                         if self._service is not None else None)
                if reply is not None:
                    self._send(_SRV_RESP, _pack_str(requester)
                               + _pack_str(req_id) + encode_trajectory(reply))
            elif tag == _SRV_RESP:
                target, off = _unpack_str(payload, 0)
                req_id, off = _unpack_str(payload, off)
                if target != self.ns:
                    continue
                msg = decode_trajectory(payload[off:])
                with self._lock:
                    if req_id in self._pending:
                        self._pending[req_id].append(msg)

    def close(self) -> None:
        self._running = False
        try:
            self._sock.close()
        except OSError:
            pass
