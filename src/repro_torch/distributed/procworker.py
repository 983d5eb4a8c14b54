"""Process-level transport for multi-host sharded serving (DESIGN.md §6).

One serving host per OS subprocess: the parent (``ShardedCascadeServer``
with ``transport="process"``) speaks a **newline-delimited JSON control
protocol** over the worker's stdin/stdout pipes, with COREWIRE blobs
(scorer artifacts, re-sync frames) riding base64-embedded in the control
lines.  The worker runs the *same* ``ShardHost`` the inline and thread
transports drive — all three transports share one protocol core; only
the call marshalling differs.  Run a worker by hand with

    PYTHONPATH=src python -m repro_torch.distributed.procworker

The worker rebuilds its synthetic workload from the seeds in the init
spec (UDFs are trained torch closures — they cannot travel over a pipe;
the generators are deterministic, so every process derives the same
query), on the spec's ``device``: a worker that cannot open that device,
or cannot load the ``cascade_score`` library there, fails its ``init``
reply and the parent raises — nothing carries on on the CPU.  It then
deserializes the initial plan from the COREWIRE artifact and answers one
request per line:

    {"cmd": "submit", "indices": <arr>, "rows": <arr>}
    {"cmd": "poll_vote"} / {"cmd": "reservoir_export"} / {"cmd": "kappa_export"}
    {"cmd": "prepare", "epoch": E, "artifact": <b64>}  -> {"ack": {...}}
    {"cmd": "commit", "epoch": E} / {"cmd": "abort"}
    {"cmd": "resync", "frame": <b64>}   (COREWIRE v1.1 catch-up frame)
    {"cmd": "track", "flag": true} / {"cmd": "drain"} / {"cmd": "stop"}

Every reply carries ``ok``, the host's current ``epoch``, and its
``submitted`` count, so the parent's mirror never drifts.  The ``drain``
reply also names the worker's ``device`` and its ``cascade_score``
launch count, which the parent keeps on ``_RemoteEngineView``.  Worker
stdout is reserved for the protocol: ``main()`` re-points fd 1 at stderr
before the heavy imports so library prints and build logs cannot corrupt
the framing.
"""
from __future__ import annotations

import base64
import json
import os
import select
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np


# ------------------------------------------------------------- marshalling
def enc_array(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    return {"b64": base64.b64encode(a.tobytes()).decode("ascii"),
            "dtype": a.dtype.str, "shape": list(a.shape)}


def dec_array(d: dict) -> np.ndarray:
    a = np.frombuffer(base64.b64decode(d["b64"]), dtype=np.dtype(d["dtype"]))
    return a.reshape(d["shape"]).copy()


def enc_bytes(b: bytes) -> str:
    return base64.b64encode(b).decode("ascii")


def dec_bytes(s: str) -> bytes:
    return base64.b64decode(s)


def enc_reservoir(rs) -> dict:
    return {
        "indices": enc_array(rs.indices), "x": enc_array(rs.x),
        "weights": enc_array(rs.weights),
        "known_sigma": {str(p): [enc_array(k), enc_array(s)]
                        for p, (k, s) in rs.known_sigma.items()},
    }


def dec_reservoir(d: dict):
    from repro_torch.serving.stats import ReservoirSample

    return ReservoirSample(
        indices=dec_array(d["indices"]), x=dec_array(d["x"]),
        weights=dec_array(d["weights"]),
        known_sigma={int(p): (dec_array(k), dec_array(s))
                     for p, (k, s) in d["known_sigma"].items()},
    )


def enc_vote(v) -> Optional[dict]:
    from repro_torch.distributed.consensus import kappa_export_to_json

    if v is None:
        return None
    ev = asdict(v.event)
    ev["order_before"] = list(ev["order_before"])
    ev["order_after"] = list(ev["order_after"])
    return {"host": v.host, "epoch": v.epoch, "event": ev,
            "reservoir": enc_reservoir(v.reservoir),
            "kappa": kappa_export_to_json(v.kappa)}


def dec_vote(d: Optional[dict]):
    from repro_torch.distributed.consensus import DriftVote, kappa_export_from_json
    from repro_torch.serving.stats import DriftEvent

    if d is None:
        return None
    ev = dict(d["event"])
    ev["order_before"] = tuple(ev["order_before"])
    ev["order_after"] = tuple(ev["order_after"])
    return DriftVote(host=int(d["host"]), epoch=int(d["epoch"]),
                     event=DriftEvent(**ev),
                     reservoir=dec_reservoir(d["reservoir"]),
                     kappa=kappa_export_from_json(d["kappa"]))


# ------------------------------------------------------------- worker side
def _open_device(name: str, threads: Optional[int]):
    """The worker's device, opened: a CUDA context and the ``cascade_score``
    library loaded on it (the parent built the library; this only loads
    it).  Raises when either fails.  ``threads`` is the parent's CPU
    thread count: the UDFs a worker trains on the CPU are the parent's
    bit for bit only at the same count (the GEMMs' reductions split by
    thread)."""
    import torch

    from repro_torch.util import resolve_device

    if threads:
        torch.set_num_threads(int(threads))
    dev = resolve_device(name)
    if dev.type == "cuda":
        from repro_torch.kernels import proxy_score

        torch.zeros(1, device=dev)
        proxy_score._lib()
    return dev


def _serve_loop(stdin, stdout) -> None:
    from repro_torch.data.synthetic import make_dataset, make_query, make_udfs
    from repro_torch.distributed.consensus import (
        SwapCommit,
        SwapPrepare,
        kappa_export_to_json,
    )
    from repro_torch.distributed.serving import ShardHost
    from repro_torch.kernels.ops import deserialize_scorer
    from repro_torch.kernels.proxy_score import cascade_score
    from repro_torch.serving.stats import AdaptivePolicy

    host: Optional[ShardHost] = None
    for line in stdin:
        if not line.strip():
            continue
        req = json.loads(line)
        cmd = req.get("cmd")
        out: dict = {"id": req.get("id")}
        try:
            if cmd == "init":
                spec = req["spec"]
                dev = _open_device(spec.get("device", "cuda"), req.get("threads"))
                ds = make_dataset(**spec["dataset"])
                udfs = make_udfs(ds, **spec["udfs"], device=dev)
                q = make_query(ds, udfs, **spec["query"])
                plan, _scorer = deserialize_scorer(
                    dec_bytes(req["artifact"]), q, device=dev)
                slo = req.get("slo_ms")
                host = ShardHost(
                    int(req["host_id"]), plan, tile=int(req["tile"]),
                    policy=AdaptivePolicy(**req["policy"]),
                    seed=int(req["seed"]),
                    slo_ms=None if slo is None else float(slo), device=dev)
            elif cmd == "submit":
                host.submit_chunk(dec_array(req["indices"]),
                                  dec_array(req["rows"]))
            elif cmd == "poll_vote":
                out["vote"] = enc_vote(host.poll_vote())
            elif cmd == "reservoir_export":
                out["reservoir"] = enc_reservoir(host.reservoir_export())
            elif cmd == "kappa_export":
                out["kappa"] = kappa_export_to_json(host.kappa_export())
            elif cmd == "prepare":
                # attempt defaults to 0 for requests from older parents
                ack = host.prepare(SwapPrepare(
                    epoch=int(req["epoch"]),
                    artifact=dec_bytes(req["artifact"]),
                    attempt=int(req.get("attempt", 0))))
                out["ack"] = {"host": ack.host, "epoch": ack.epoch,
                              "ok": ack.ok, "error": ack.error,
                              "attempt": ack.attempt}
            elif cmd == "commit":
                host.commit(SwapCommit(epoch=int(req["epoch"]),
                                       attempt=int(req.get("attempt", 0))))
            elif cmd == "abort":
                host.abort()
            elif cmd == "resync":
                out["epoch_installed"] = host.resync(dec_bytes(req["frame"]))
                out["resyncs"] = host.resyncs
            elif cmd == "track":
                host.track_versions = bool(req["flag"])
            elif cmd == "drain":
                st = host.drain()
                d = asdict(st)
                d["drift_events"] = []  # local events stay host-side
                out["stats"] = d
                out["emitted"] = [int(i) for i in host.engine.emitted]
                out["emitted_versions"] = [
                    int(v) for v in host.engine.emitted_versions]
                out["plan_version"] = int(host.engine.plan_version)
                out["in_flight"] = int(host.engine.in_flight())
                out["submit_version"] = [
                    [int(i), int(v)] for i, v in host.submit_version.items()]
                # where this worker served, and how many kernel launches
                # it made there (0 on the CPU, where nothing launches)
                out["device"] = str(host.engine.device)
                out["launches"] = int(cascade_score.launches)
                if host.frontend is not None:
                    # goodput accounting lives in this subprocess; the
                    # parent's fleet aggregation needs the scalars
                    out["frontend_stats"] = asdict(host.frontend.stats)
            elif cmd == "stop":
                out.update(ok=True, epoch=host.epoch if host else 0,
                           submitted=host.submitted if host else 0)
                stdout.write(json.dumps(out) + "\n")
                stdout.flush()
                return
            else:
                raise ValueError(f"unknown command {cmd!r}")
            out.update(ok=True, epoch=host.epoch if host else 0,
                       submitted=host.submitted if host else 0)
        except Exception as e:  # surfaced parent-side as an RPC error
            import traceback

            out = {"id": req.get("id"), "ok": False,
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc(limit=8)}
        stdout.write(json.dumps(out) + "\n")
        stdout.flush()


def main() -> None:
    # the protocol owns real-stdout; anything a library prints lands on
    # stderr so it cannot corrupt the newline framing
    proto_out = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    _serve_loop(sys.stdin, proto_out)


# ------------------------------------------------------------- parent side
class _RemoteEngineView:
    """Parent-side mirror of a worker host's engine surface — filled at
    drain so stats aggregation and the conservation checks read process
    hosts exactly like in-process ones.  ``device`` and ``launches`` are
    the worker's own, as its drain reply gave them."""

    def __init__(self):
        from repro_torch.serving.engine import ServeStats

        self.stats = ServeStats(stage_in=[], stage_udf_batches=[],
                                stage_kept=[], stage_proxy_ms=[],
                                stage_used_kernel=[])
        self.emitted: list = []
        self.emitted_versions: list = []
        self.plan_version = 0
        self._in_flight = 0
        self.device: Optional[str] = None
        self.launches = 0

    def in_flight(self) -> int:
        return self._in_flight


class ProcessHost:
    """RPC proxy for one subprocess host — API-identical to ``ShardHost``
    (the same serving loop runs all three transports).  The constructor
    spawns the worker and sends it its ``init``; ``wait_ready`` takes the
    reply, so that ``start_process_hosts`` warms every worker up at once.
    The worker trains at this process's CPU thread count."""

    def __init__(self, host_id: int, *, spec: dict, artifact: bytes,
                 tile: int, policy, seed: int,
                 slo_ms: Optional[float] = None,
                 init_timeout_s: float = 600.0):
        import torch

        import repro_torch
        from repro_torch.util import advisory_wall_ms

        src_dir = Path(repro_torch.__file__).resolve().parents[1]
        env = dict(os.environ)
        env["PYTHONPATH"] = (str(src_dir) + os.pathsep
                             + env.get("PYTHONPATH", ""))
        # K workers' CPU thread pools share the host's cores: spinning
        # OpenMP waits would stall one another's parallel regions
        env.setdefault("OMP_WAIT_POLICY", "PASSIVE")
        self._t0_ms = advisory_wall_ms()
        self._proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "repro_torch.distributed.procworker"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            env=env)
        self.host_id = int(host_id)
        self.engine = _RemoteEngineView()
        self.epoch = 0
        self.submitted = 0
        self.resyncs = 0
        self.submit_version: Dict[int, int] = {}
        # mirror of the worker-side request front end: None until a drain
        # reply carries frontend stats across the pipe (slo_ms set)
        self.frontend = None
        self._track = False
        self._req_id = 0
        self._init_timeout_s = float(init_timeout_s)
        self.start_s: Optional[float] = None  # spawn to init reply (advisory)
        self._send({"cmd": "init", "host_id": host_id, "spec": spec,
                    "artifact": enc_bytes(artifact), "tile": tile,
                    "policy": asdict(policy), "seed": seed,
                    "slo_ms": None if slo_ms is None else float(slo_ms),
                    "threads": torch.get_num_threads()})

    def wait_ready(self) -> None:
        """Take the worker's ``init`` reply (raises if it failed or if the
        worker stayed silent past ``init_timeout_s``)."""
        from repro_torch.util import advisory_wall_ms

        self._recv("init", timeout=self._init_timeout_s)
        self.start_s = (advisory_wall_ms() - self._t0_ms) / 1e3

    def _send(self, req: dict) -> None:
        self._req_id += 1
        self._proc.stdin.write(json.dumps(dict(req, id=self._req_id)) + "\n")
        self._proc.stdin.flush()

    def _recv(self, cmd: str, timeout: Optional[float] = None) -> dict:
        from repro_torch.distributed.serving import HostTimeout

        rep = None
        while rep is None or rep.get("id") != self._req_id:
            # discard stale replies (a host that answered AFTER a prior
            # call's deadline expired): request ids keep the channel in
            # sync instead of mistaking the late line for this reply
            if timeout is not None:
                ready, _, _ = select.select(
                    [self._proc.stdout], [], [], timeout)
                if not ready:
                    raise HostTimeout(
                        f"host {self.host_id} silent past {timeout}s "
                        f"deadline ({cmd})")
            line = self._proc.stdout.readline()
            if not line:
                raise RuntimeError(
                    f"host {self.host_id} worker exited (rc="
                    f"{self._proc.poll()}) during {cmd!r}")
            rep = json.loads(line)
        if not rep.get("ok"):
            raise RuntimeError(
                f"host {self.host_id} {cmd!r} failed: "
                f"{rep.get('error')}\n{rep.get('trace', '')}")
        self.epoch = int(rep.get("epoch", self.epoch))
        return rep

    def _rpc(self, req: dict, timeout: Optional[float] = None) -> dict:
        self._send(req)
        return self._recv(req.get("cmd"), timeout=timeout)

    # ------------------------------------------------------- ShardHost API
    @property
    def track_versions(self) -> bool:
        return self._track

    @track_versions.setter
    def track_versions(self, flag: bool) -> None:
        self._track = bool(flag)
        self._rpc({"cmd": "track", "flag": bool(flag)})

    def submit_chunk(self, indices, rows) -> None:
        self._rpc({"cmd": "submit", "indices": enc_array(np.asarray(indices)),
                   "rows": enc_array(np.asarray(rows, np.float32))})
        self.submitted += len(rows)

    def poll_vote(self):
        return dec_vote(self._rpc({"cmd": "poll_vote"}).get("vote"))

    def reservoir_export(self):
        return dec_reservoir(
            self._rpc({"cmd": "reservoir_export"})["reservoir"])

    def kappa_export(self):
        from repro_torch.distributed.consensus import kappa_export_from_json

        return kappa_export_from_json(self._rpc({"cmd": "kappa_export"})["kappa"])

    def prepare(self, msg, timeout: Optional[float] = None):
        from repro_torch.distributed.consensus import SwapAck

        rep = self._rpc({"cmd": "prepare", "epoch": msg.epoch,
                         "artifact": enc_bytes(msg.artifact),
                         "attempt": msg.attempt},
                        timeout=timeout)
        return SwapAck(**rep["ack"])

    def commit(self, msg) -> None:
        self._rpc({"cmd": "commit", "epoch": msg.epoch,
                   "attempt": msg.attempt})

    def abort(self) -> None:
        self._rpc({"cmd": "abort"})

    def resync(self, frame: bytes) -> int:
        rep = self._rpc({"cmd": "resync", "frame": enc_bytes(frame)})
        self.resyncs = int(rep.get("resyncs", self.resyncs + 1))
        return int(rep["epoch_installed"])

    def drain(self):
        rep = self._rpc({"cmd": "drain"})
        view = self.engine
        for k, v in rep["stats"].items():
            setattr(view.stats, k, v)
        view.emitted = list(rep["emitted"])
        view.emitted_versions = list(rep["emitted_versions"])
        view.plan_version = int(rep["plan_version"])
        view._in_flight = int(rep["in_flight"])
        view.device = rep.get("device")
        view.launches = int(rep.get("launches", 0))
        self.submit_version = {int(i): int(v)
                               for i, v in rep["submit_version"]}
        if rep.get("frontend_stats") is not None:
            from types import SimpleNamespace

            from repro_torch.serving.frontend import FrontEndStats

            self.frontend = SimpleNamespace(
                stats=FrontEndStats(**rep["frontend_stats"]))
        return view.stats

    def stop(self) -> None:
        if self._proc.poll() is None:
            try:
                self._rpc({"cmd": "stop"}, timeout=30.0)
            except Exception:
                pass
        try:
            self._proc.stdin.close()
        except Exception:
            pass
        try:
            self._proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            # a wedged worker must not discard the caller's completed run
            # (stop() runs inside the drain loop) or leak past cleanup
            self.kill()

    def kill(self) -> None:
        """End the worker now, whatever it is doing (a fleet whose start
        failed does not wait for its other workers' warm-up)."""
        if self._proc.poll() is None:
            self._proc.kill()
        self._proc.wait(timeout=10)


def start_process_hosts(n_hosts: int, *, spec: dict, artifact: bytes,
                        tile: int, policy, seed: int,
                        slo_ms: Optional[float] = None,
                        init_timeout_s: float = 600.0) -> List[ProcessHost]:
    """Spawn ``n_hosts`` workers (host k seeded ``seed + 1000 k``), send
    every one its ``init`` before awaiting any reply, then await them all.
    If any worker fails to start, every worker is stopped and the error
    propagates."""
    hosts: List[ProcessHost] = []
    try:
        for k in range(n_hosts):
            hosts.append(ProcessHost(
                k, spec=spec, artifact=artifact, tile=tile, policy=policy,
                seed=seed + 1000 * k, slo_ms=slo_ms,
                init_timeout_s=init_timeout_s))
        for h in hosts:
            h.wait_ready()
    except BaseException:
        for h in hosts:
            h.kill()
        raise
    return hosts


if __name__ == "__main__":
    main()
