"""System orchestrator (port of isvins_tpu/system.py): the single-process
host pipeline that replaces the reference's 7-thread queue topology
(src/System.cpp; SURVEY.md section 1).

Dataflow:

  pub_imu  --> imu queue --+
  pub_image -> frequency control -> FeatureTracker -> feature queue
                                    | (image ring buffer for keyframes)
  _process: align IMU <= t_img + td (mid-frame interpolation) -> Estimator
            | MARGIN_OLD -> PoseGraphPacket + keyframe points + image
            +-> PoseGraphBuilder (loop closure, drift), inline or on a worker

Outputs: the VIO trajectory (pose_output.txt semantics, System.cpp:409-410),
the optimized keyframe trajectory (loop_pose_output.txt) and the
per-keyframe covariance dump.

Every stage runs on the System's device (None: the CUDA card; the CPU only
on `device="cpu"`). The pose-graph worker thread enqueues on a CUDA stream
of its own for its whole life: a new thread would otherwise start on the
device's default stream, where the tracker step also runs, and every host
read the worker makes would wait for the frame thread's queued work. Its
inputs are host numpy packets, so no tensor crosses the two streams.
"""

from __future__ import annotations

import bisect
import queue
import threading
from collections import deque
from typing import List, Optional, Tuple

import numpy as np
import torch

from .config import EngineConfig
from .device import resolve_device
from .estimator.estimator import NON_LINEAR, Estimator
from .frontend import FeatureTracker, make_camera
from .posegraph import PoseGraphBuilder
from .solver import WindowDims
from .utils import perf


class System:
    def __init__(self, cfg: EngineConfig, dims: Optional[WindowDims] = None,
                 enable_loop: bool = True, pipeline: bool = False,
                 pg_thread: bool = False, solve_async: bool = False, device=None):
        """pipeline=True pipelines the tracker: pub_image dispatches this
        frame's tracker step without waiting for the device and runs the
        PREVIOUS frame's estimator update while it computes (the
        reference's tracker/backend thread pair, System.cpp:224). Outputs
        equal the synchronous mode's, one pub_image later; call flush() at
        the end of the stream.

        pg_thread=True runs the whole pose-graph builder (keyframe BRIEF,
        retrieval, PnP loop verification, optimization dispatch) on a
        worker thread that consumes a packet queue in order (the
        reference's pose-graph process thread). The builder is a pure
        consumer of the VIO stream, so outputs equal the inline builder's
        after a flush; only WHEN drift updates land differs.

        solve_async=True pipelines the estimator's steady solve across
        frames (Estimator(solve_async=True)); the solve is collected at the
        start of the next frame, before its IMU feed."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.pipeline = pipeline
        self._pending_pub = None  # (t, pub_this) of the in-flight tracker frame
        self.tracker = FeatureTracker(cfg.camera, cfg.tracker, device=self.device)
        self.estimator = Estimator(cfg, dims, device=self.device, solve_async=solve_async)
        self.pgbuilder = (PoseGraphBuilder(cfg, camera=make_camera(cfg.camera),
                                           device=self.device)
                          if (enable_loop and cfg.posegraph.enabled) else None)
        self._pg_queue: Optional[queue.Queue] = None
        self._pg_worker_thread: Optional[threading.Thread] = None
        self._pg_exc: Optional[BaseException] = None
        if self.pgbuilder is not None and pg_thread:
            # bounded: back-pressure if the worker ever falls behind the
            # keyframe rate
            self._pg_queue = queue.Queue(maxsize=64)
            self._pg_worker_thread = threading.Thread(
                target=self._pg_worker, daemon=True, name="posegraph")
            self._pg_worker_thread.start()
            # the worker's first keyframe step, match, PnP and optimize pay
            # the CUDA libraries' start-up; run them ahead of any keyframe
            self._pg_queue.put(("prewarm",))

        self.imu_buf: deque = deque()
        self.feature_buf: deque = deque()
        self.image_ring: deque = deque(maxlen=256)  # (t, uint8 image)

        self.first_image_time = None
        self.last_image_time = None
        self.pub_count = 0
        self.init_feature = True  # skip the first packet (no velocities yet)
        self.current_time = -1.0

        self.vio_trajectory: List[Tuple[float, np.ndarray, np.ndarray]] = []
        self._pg_cursor = 0
        # frame ids: pub_image's call count; (t, frame) of each packet handed
        # to the estimator, until its pose comes out
        self._frames_fed = 0
        self._packet_frames: deque = deque(maxlen=256)

    # ------------------------------------------------------------------- inputs
    def pub_imu(self, t: float, acc, gyr):
        """Buffer an IMU sample; the estimator steps the packets it
        completes, under the root span `sys.pub_imu`."""
        self.imu_buf.append((t, np.asarray(acc), np.asarray(gyr)))
        if self._measurements_ready():
            with perf.phase("sys.pub_imu", frame=self.feature_buf[0]["frame"]):
                self._process()

    def pub_image(self, t: float, img: np.ndarray):
        """Frequency control + tracking (System.cpp:54-142), under the root
        span `sys.frame` of this call's frame id (the count of earlier
        calls)."""
        frame, self._frames_fed = self._frames_fed, self._frames_fed + 1
        with perf.phase("sys.frame", frame=frame):
            self._pub_image(t, img, frame)

    def _pub_image(self, t: float, img: np.ndarray, frame: int):
        if self.first_image_time is None:
            self.first_image_time = t
            self.last_image_time = t
        # stream discontinuity (System.cpp:72-79): reset the LK tracker and
        # start a new pose-graph sequence, after the last pre-gap frame is
        # fully consumed
        if t - self.last_image_time > 1.0 or t < self.last_image_time:
            self._collect_pending()
            self._process()
            self.first_image_time = t
            self.pub_count = 0
            self.init_feature = True
            self.tracker.reset()
            self.feature_buf.clear()
            if self.pgbuilder is not None:
                if self._pg_queue is not None:
                    # ordered with the packets already queued: the worker
                    # owns all builder state
                    self._pg_queue.put(("new_seq",))
                else:
                    self.pgbuilder.new_sequence()
        self.last_image_time = t

        # frequency control (System.cpp:82-95)
        freq = self.cfg.tracker.freq
        pub_this = False
        if freq <= 0 or round(self.pub_count / max(t - self.first_image_time, 1e-9)) <= freq:
            pub_this = True
            if abs(self.pub_count / max(t - self.first_image_time, 1e-9) - freq) < 0.01 * freq:
                self.first_image_time = t
                self.pub_count = 0

        if pub_this:
            self.pub_count += 1
        # the cast truncates float frames, as the JAX package's ring does, so
        # that both packages' keyframe BRIEF sees the same image
        self.image_ring.append((t, np.asarray(img, dtype=np.uint8)))
        if self.pipeline:
            # finish the previous frame's tracking, dispatch this frame's
            # step, and run the estimator on the queued packet meanwhile
            self._collect_pending(dispatch_next=(t, pub_this, img, frame))
            self._process()
        else:
            out = self.tracker.read_image(img, t)
            self._queue_packet(t, pub_this, out, frame)
            self._process()

    def _collect_pending(self, dispatch_next=None):
        """Collect the in-flight tracker frame (if any) into the feature
        queue, then optionally dispatch the next frame."""
        if self._pending_pub is not None:
            t0, pub0, frame0 = self._pending_pub
            self._pending_pub = None
            with perf.phase("trk.collect", frame=frame0):
                out = self.tracker.collect()
            self._queue_packet(t0, pub0, out, frame0)
        if dispatch_next is not None:
            t, pub_this, img, frame = dispatch_next
            with perf.phase("trk.dispatch", frame=frame):
                self.tracker.dispatch(img, t)
            self._pending_pub = (t, pub_this, frame)

    def _queue_packet(self, t: float, pub_this: bool, out: dict, frame: int):
        if not pub_this:
            return
        if self.init_feature:
            # the first packet has no velocities; the reference skips it
            self.init_feature = False
            return
        sel = out["track_cnt"] > 1
        if sel.sum() == 0:
            return
        self.feature_buf.append({"t": t, "ids": out["ids"][sel], "pts": out["pts_norm"][sel],
                                 "vel": out["vel"][sel], "frame": frame})

    def flush(self):
        """End of stream: finish the in-flight tracker frame, drain the
        queues, collect the last solve and marginalization, drain the
        pose-graph worker and collect any in-flight optimization."""
        self._collect_pending()
        self._process()
        self.estimator.collect_solve()
        self.estimator.collect_marg()
        self._drain_outputs()
        self._pg_join()
        if self.pgbuilder is not None:
            self.pgbuilder.flush_optimize()

    def close(self):
        """Stop the pose-graph worker and the estimator's marginalization
        worker (after flush(); a parked worker failure is raised)."""
        if self._pg_worker_thread is not None:
            self._pg_join()
            self._pg_queue.put(None)
            self._pg_worker_thread.join()
            self._pg_worker_thread = None
        self.estimator.close()

    # ----------------------------------------------------- pose-graph thread
    def _pg_worker(self):
        """Worker loop: consume (prewarm / push / new_seq) commands in
        order on the worker's own CUDA stream. An exception is parked and
        raised on the caller's thread at the next join; the VIO stream never
        depends on the pose graph."""
        stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        with torch.cuda.stream(stream):  # a None stream is a no-op context
            while True:
                item = self._pg_queue.get()
                try:
                    if item is None:
                        return
                    if self._pg_exc is None:
                        if item[0] == "new_seq":
                            self.pgbuilder.new_sequence()
                        elif item[0] == "prewarm":
                            self.pgbuilder.prewarm()
                        else:
                            _, pkt, kfp, img, frame, parent = item
                            with perf.phase("pg.push", frame=frame, parent=parent):
                                self.pgbuilder.push(pkt, kfp, image=img)
                except BaseException as e:  # noqa: BLE001 - raised at the next join
                    self._pg_exc = e
                finally:
                    self._pg_queue.task_done()

    def wait_pg_ready(self):
        """Block until the pose-graph worker has drained its queue (in
        particular the start-up prewarm). Call before a timed or
        rate-critical stream, and before saving the pose graph
        (utils.checkpoint.save_pose_graph)."""
        self._pg_join()

    def _pg_join(self):
        """Drain the pose-graph queue (no-op without pg_thread) and raise a
        parked worker failure. Every output accessor calls this."""
        if self._pg_queue is not None:
            self._pg_queue.join()
            if self._pg_exc is not None:
                exc, self._pg_exc = self._pg_exc, None
                raise RuntimeError("pose-graph worker failed") from exc

    # -------------------------------------------------------------- processing
    def _measurements_ready(self) -> bool:
        if not self.feature_buf or not self.imu_buf:
            return False
        return self.imu_buf[-1][0] > self.feature_buf[0]["t"] + self.cfg.solver.td

    def _process(self):
        """getMeasurements + ProcessBackEnd (System.cpp:160-202, 224-415)."""
        while self._measurements_ready():
            feat = self.feature_buf.popleft()
            frame = feat["frame"]
            t_img = feat["t"] + self.cfg.solver.td
            est = self.estimator
            # install the previous frame's pipelined solve BEFORE the IMU
            # feed: process_imu propagates the newest state as the incoming
            # frame's initial guess (no-op unless solve_async)
            est.collect_solve()
            self._drain_outputs(frame)
            if self.current_time < 0:
                self.current_time = t_img
            with perf.phase("sys.imu_feed", frame=frame):
                self._feed_imu(t_img)
            self._packet_frames.append((feat["t"], frame))
            with perf.phase("est.process_image", frame=frame):
                est.process_image(feat["ids"], feat["pts"], feat["t"], vels=feat["vel"])
            self._drain_outputs(frame)

    def _drain_outputs(self, frame: Optional[int] = None):
        """Move finished poses to the trajectory, each recorded as the
        instant `sys.pose_out` of its packet's frame, and feed the pose
        graph (the packets found while processing `frame`)."""
        est = self.estimator
        if est.ready_poses:
            for t, _, _ in est.ready_poses:
                perf.event("sys.pose_out", frame=self._pose_frame(t))
            self.vio_trajectory.extend(est.ready_poses)
            est.ready_poses.clear()
        if est.solver_flag == NON_LINEAR:
            with perf.phase("sys.feed_pose_graph", frame=frame):
                self._feed_pose_graph(frame)

    def _pose_frame(self, t: float) -> Optional[int]:
        """The frame of the packet at time `t`; the packets before it put
        out no pose and are dropped with it."""
        for i, (ti, frame) in enumerate(self._packet_frames):
            if ti == t:
                for _ in range(i + 1):
                    self._packet_frames.popleft()
                return frame
        return None

    def _feed_imu(self, t_img: float):
        """Feed the IMU up to t_img; the sample straddling it is split by
        linear interpolation (System.cpp:279-296)."""
        est = self.estimator
        while self.imu_buf and self.imu_buf[0][0] < t_img:
            t, acc, gyr = self.imu_buf.popleft()
            dt = t - self.current_time
            if dt > 0:
                est.process_imu(dt, acc, gyr)
            self.current_time = t
            self._last_imu = (acc, gyr)
        if self.imu_buf:
            t2, acc2, gyr2 = self.imu_buf[0]
            dt1 = t_img - self.current_time
            dt2 = t2 - t_img
            if dt1 > 0 and dt2 >= 0 and hasattr(self, "_last_imu"):
                w1 = dt2 / max(dt1 + dt2, 1e-9)
                w2 = dt1 / max(dt1 + dt2, 1e-9)
                acc1, gyr1 = self._last_imu
                acc_i = w1 * acc1 + w2 * acc2
                gyr_i = w1 * gyr1 + w2 * gyr2
                est.process_imu(dt1, acc_i, gyr_i)
                self.current_time = t_img

    def _feed_pose_graph(self, frame: Optional[int]):
        """Hand the new keyframe packets to the builder: queued for the
        worker with `frame` and the span that queues them, or pushed here."""
        if self.pgbuilder is None:
            return
        est = self.estimator
        while self._pg_cursor < len(est.pose_graph_packets):
            pkt = est.pose_graph_packets[self._pg_cursor]
            kfp = (est.keyframe_points[self._pg_cursor]
                   if self._pg_cursor < len(est.keyframe_points) else None)
            img = self._lookup_image(float(pkt.ts))
            if self._pg_queue is not None:
                self._pg_queue.put(("push", pkt, kfp, img, frame, perf.current()))
            else:
                self.pgbuilder.push(pkt, kfp, image=img)
            self._pg_cursor += 1

    def _lookup_image(self, t: float):
        """The ring image nearest in time (bisect on the time-ordered ring),
        as f32, if within 50 ms."""
        if not self.image_ring:
            return None
        ts = [ti for (ti, _) in self.image_ring]
        i = bisect.bisect_left(ts, t)
        cands = [j for j in (i - 1, i) if 0 <= j < len(ts)]
        j = min(cands, key=lambda k: abs(ts[k] - t))
        if abs(ts[j] - t) < 0.05:
            return self.image_ring[j][1].astype(np.float32)
        return None

    # ---------------------------------------------------------------- outputs
    def vio_tum(self) -> str:
        """TUM format: t x y z qx qy qz qw (System.cpp:409-410)."""
        return "\n".join(f"{t:.9f} {P[0]} {P[1]} {P[2]} {Q[1]} {Q[2]} {Q[3]} {Q[0]}"
                         for (t, P, Q) in self.vio_trajectory)

    def loop_tum(self) -> str:
        if self.pgbuilder is None:
            return ""
        self._pg_join()
        ts, t_opt, q_opt = self.pgbuilder.trajectory()
        return "\n".join(f"{ts[i]:.9f} {P[0]} {P[1]} {P[2]} {Q[1]} {Q[2]} {Q[3]} {Q[0]}"
                         for i, (P, Q) in enumerate(zip(t_opt, q_opt)))

    def covariance_tum(self) -> str:
        """Per-keyframe 6x6 covariance dump (the reference's live Pangolin
        ellipses, pose_graph_builder.cpp:272-301, as a text artifact)."""
        if self.pgbuilder is None:
            return ""
        self._pg_join()
        from .utils.visualization import covariance_tum

        ts, t_opt, cov = self.pgbuilder.covariances()
        return covariance_tum(ts, t_opt, cov)
