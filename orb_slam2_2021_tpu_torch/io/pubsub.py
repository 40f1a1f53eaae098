"""Pub/sub: the engine's ROS-free message surface (the port's own copy of
orb_slam2_2021_tpu/io/pubsub.py; host code, numpy, json, sockets and
threads).

The upstream system's only IPC is ROS pub/sub: its GridMapping thread
publishes the occupancy grid, the grid pose and the map point cloud
(`os2_gm`, `os2_gm_pose`, `os2_pointcloud`), its camera program the live
camera pose (`os2_pose`), and its pc2ls launch file relays the point cloud
to a laser scan.

Here the same topics flow over an in-process bus with an optional
newline-delimited-JSON TCP fan-out, so external consumers (rviz bridges,
loggers) can subscribe without ROS. `pointcloud_to_laserscan` is the pc2ls
relay with that launch file's parameters.
"""

from __future__ import annotations

import json
import socket
import threading
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np

TOPIC_POSE = "os2_pose"
TOPIC_POINTCLOUD = "os2_pointcloud"
TOPIC_GRID = "os2_gm"
TOPIC_GRID_POSE = "os2_gm_pose"
TOPIC_SCAN = "os2_scan"
TOPIC_METRICS = "os2_metrics"

# a subscriber that takes longer than this to accept one message is dropped
SEND_TIMEOUT_S = 2.0


class MessageBus:
    """In-process topic bus; thread-safe; last-value cache per topic."""

    def __init__(self):
        self._subs: Dict[str, List[Callable]] = defaultdict(list)
        self._latest: Dict[str, object] = {}
        self._lock = threading.Lock()

    def subscribe(self, topic: str, fn: Callable):
        with self._lock:
            self._subs[topic].append(fn)

    def publish(self, topic: str, msg):
        with self._lock:
            self._latest[topic] = msg
            subs = list(self._subs[topic])
        for fn in subs:
            fn(msg)

    def latest(self, topic: str):
        with self._lock:
            return self._latest.get(topic)


def _to_jsonable(msg):
    if isinstance(msg, np.ndarray):
        return {"__nd__": True, "dtype": str(msg.dtype), "shape": msg.shape,
                "data": msg.ravel().tolist()}
    if isinstance(msg, dict):
        return {k: _to_jsonable(v) for k, v in msg.items()}
    if isinstance(msg, (list, tuple)):
        return [_to_jsonable(v) for v in msg]
    if isinstance(msg, (np.integer,)):
        return int(msg)
    if isinstance(msg, (np.floating,)):
        return float(msg)
    return msg


class TcpPublisher:
    """NDJSON TCP fan-out: each line is {"topic": ..., "msg": ...}.

    Bind with port=0 to get an ephemeral port (`.port`). Subscribers connect
    and stream; a subscriber that fails or stalls a send for SEND_TIMEOUT_S
    is dropped rather than back-pressuring SLAM. `close` stops the accept
    thread and closes every socket.
    """

    def __init__(self, bus: MessageBus, topics, host="127.0.0.1", port: int = 0):
        self.bus = bus
        self._clients: List[socket.socket] = []
        self._lock = threading.Lock()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(8)
        self.port = self._srv.getsockname()[1]
        self._stop = False
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept_thread.start()
        for t in topics:
            bus.subscribe(t, lambda msg, _t=t: self._fanout(_t, msg))

    def _accept_loop(self):
        while not self._stop:
            try:
                c, _ = self._srv.accept()
            except OSError:
                return
            c.settimeout(SEND_TIMEOUT_S)
            with self._lock:
                if self._stop:
                    c.close()
                    return
                self._clients.append(c)

    @property
    def n_subscribers(self) -> int:
        with self._lock:
            return len(self._clients)

    def _fanout(self, topic: str, msg):
        line = (json.dumps({"topic": topic, "msg": _to_jsonable(msg)}) + "\n").encode()
        with self._lock:
            alive = []
            for c in self._clients:
                try:
                    c.sendall(line)
                    alive.append(c)
                except OSError:
                    try:
                        c.close()
                    except OSError:
                        pass
            self._clients = alive

    def close(self):
        with self._lock:
            self._stop = True
        try:
            # wakes the accept() blocked in the accept thread (close alone
            # does not, on Linux)
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._srv.close()
        self._accept_thread.join(timeout=SEND_TIMEOUT_S)
        with self._lock:
            for c in self._clients:
                try:
                    c.close()
                except OSError:
                    pass
            self._clients = []


def pointcloud_to_laserscan(
    points_xyz: np.ndarray,
    min_height: float = -0.5,
    max_height: float = 0.5,
    angle_min: float = -np.pi,
    angle_max: float = np.pi,
    angle_increment: float = np.pi / 360.0,
    range_min: float = 0.3,
    range_max: float = 40.0,
):
    """pointcloud_to_laserscan relay (the pc2ls launch file's parameters).

    points_xyz: [N, 3] in camera/world coords with y = height axis (the
    SLAM convention here; the launch file remaps z-up ROS frames).
    Returns (ranges [M], angles [M]) with inf where no return.
    """
    p = np.asarray(points_xyz, np.float64)
    if p.ndim != 2 or p.shape[0] == 0:
        n = int(np.ceil((angle_max - angle_min) / angle_increment))
        return np.full(n, np.inf), angle_min + angle_increment * np.arange(n)
    keep = (p[:, 1] >= min_height) & (p[:, 1] <= max_height)
    x, z = p[keep, 0], p[keep, 2]
    rng = np.hypot(x, z)
    ang = np.arctan2(x, z)
    ok = (rng >= range_min) & (rng <= range_max) & (ang >= angle_min) & (ang < angle_max)
    rng, ang = rng[ok], ang[ok]
    n = int(np.ceil((angle_max - angle_min) / angle_increment))
    bins = np.clip(((ang - angle_min) / angle_increment).astype(int), 0, n - 1)
    ranges = np.full(n, np.inf)
    np.minimum.at(ranges, bins, rng)
    angles = angle_min + angle_increment * (np.arange(n) + 0.5)
    return ranges, angles


class SystemPublisher:
    """Wires a System's live outputs onto the bus each frame.

    Reads the port's System: `tracker.last_pose`, `metrics`,
    `point_cloud()` and `occupancy_grid()` (numpy and plain Python types;
    in async mode the last two take the map lock and wait for the mapping
    stream). Covers the upstream camera program's pose publisher and
    GridMapping::PublishPC / BuildOccupancyGridMsg (cloud, grid, grid pose).
    """

    def __init__(self, system, bus: Optional[MessageBus] = None,
                 publish_scan: bool = False):
        self.system = system
        self.bus = bus or MessageBus()
        self.publish_scan = publish_scan

    def publish_frame(self, timestamp: float):
        sys_ = self.system
        pose = sys_.tracker.last_pose
        if pose is not None:
            R, t = pose
            Twc = np.eye(4)
            Twc[:3, :3] = np.asarray(R).T
            Twc[:3, 3] = -np.asarray(R).T @ np.asarray(t)
            self.bus.publish(TOPIC_POSE, {"t": timestamp, "Twc": Twc})
        if sys_.metrics:
            # the per-frame record (io/metrics.py schema)
            self.bus.publish(TOPIC_METRICS, sys_.metrics[-1])

    def publish_map(self, timestamp: float):
        sys_ = self.system
        pc = sys_.point_cloud()
        if pc is not None:
            self.bus.publish(TOPIC_POINTCLOUD, {"t": timestamp, "points": pc})
            if self.publish_scan:
                ranges, angles = pointcloud_to_laserscan(pc)
                self.bus.publish(TOPIC_SCAN,
                                 {"t": timestamp, "ranges": ranges, "angles": angles})
        grid = sys_.occupancy_grid()
        if grid is not None:
            self.bus.publish(TOPIC_GRID, {
                "t": timestamp, "data": grid.data,
                "resolution": grid.resolution,
                "origin_x": grid.origin_x, "origin_z": grid.origin_z,
            })
            self.bus.publish(TOPIC_GRID_POSE, {
                "t": timestamp, "origin_x": grid.origin_x, "origin_z": grid.origin_z,
            })
