"""Timer-driven TF/odometry broadcast — port of
``coxgraph_tpu.comm.tf_broadcast``: the push half of the transform
tree (the pull half is frames()/global_frames()).

The reference broadcasts transforms continuously for external consumers:
TfPublisher re-publishes odom→sensor TF + nav_msgs/Odometry on a 10 ms
timer inside every SLAM frontend (tf_publisher.h:38-100), and the server
broadcasts the optimized T_G_Client set at 100 Hz (kTfPubFreq,
global_tf_controller.h:122, pubCliTfCallback global_tf_controller.cpp:
40-46). Here ONE broadcaster thread samples any frames() source at a
configured rate and publishes stamped TF-set snapshots on a latched bus
topic; TfListener is the consumer-side cache (the tf2 buffer role)."""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from . import wire
from .bus import BusClient


class TfBroadcaster:
    """Publish a frames() snapshot on `topic` at `rate_hz` from a
    background thread. ``source`` is any zero-arg callable returning
    {(parent_frame, child_frame): pose7} — e.g.
    ``vio.frames`` (odom→imu→sensor chain, TfPublisher parity) or
    ``server.global_frames`` (T_G_Client set, GlobalTfController
    parity). An empty dict publishes nothing that tick (the reference
    also skips when out of control, global_tf_controller.cpp:41)."""

    def __init__(self, port: int, source: Callable[[], dict],
                 rate_hz: float = 100.0, topic: str = "tf",
                 host: str = "127.0.0.1"):
        self.bus = BusClient(port, host)
        self.source = source
        self.topic = topic
        self.period = 1.0 / rate_hz
        self.n_published = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            t0 = time.monotonic()
            try:
                frames = self.source()
                if frames:
                    self.bus.publish(self.topic, wire.pack_tf_set(
                        time.time(),
                        {k: np.asarray(v, np.float32)
                         for k, v in frames.items()}))
                    self.n_published += 1
            except OSError:
                break   # bus gone — broadcaster dies quietly with it
            self._stop.wait(max(0.0, self.period - (time.monotonic() - t0)))

    def close(self) -> None:
        self._stop.set()
        self._thread.join()
        self.bus.close()


class TfListener:
    """Consumer-side transform cache (the tf2 buffer role): subscribes
    to the broadcast topic and keeps the latest stamped snapshot; the
    bus topic is latched, so a late listener gets the last snapshot
    immediately."""

    def __init__(self, port: int, topic: str = "tf",
                 host: str = "127.0.0.1"):
        self.bus = BusClient(port, host)
        self.topic = topic
        self.bus.subscribe(topic)
        self.stamp: float = 0.0
        self.frames: Dict[Tuple[str, str], np.ndarray] = {}

    def spin_once(self, timeout_ms: int = 0) -> bool:
        """Drain pending snapshots; → whether anything new arrived."""
        got = False
        while True:
            msg = self.bus.poll(timeout_ms if not got else 0)
            if msg is None:
                return got
            if msg[0] == "pub" and msg[1] == self.topic:
                self.stamp, self.frames = wire.unpack_tf_set(msg[2])
                got = True

    def lookup(self, parent: str, child: str) -> Optional[np.ndarray]:
        return self.frames.get((parent, child))

    def close(self) -> None:
        self.bus.close()
