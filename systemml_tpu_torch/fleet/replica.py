# Port of systemml_tpu/fleet/replica.py, with its imports pointed at
# systemml_tpu_torch, and one repair: a 429 reads the request's body
# before it answers (_ScoreHandler._send_429). FleetMember raises until
# item 12 brings the mesh reform it drives.
"""Serving replica: one scoring process in the fleet.

Each process in a replicated serving job wraps its scorer in a
``Replica``: a set of per-program-generation HTTP endpoints
(``ReplicaEndpoint``), a liveness registration file in the shared
fleet directory (the same directory the trace shards and metrics
snapshots of ``obs/fleet.py`` live in, so one merge sees both), and a
pause gate a recovery path uses to fence scoring.

Identity is the fleet identity of ``obs/fleet.py``: the registration
carries run_id / original rank / current rank / generation, plus the
same ``handshake_payload`` clock announcement a training handshake
uses — a registry scan doubles as a clock-probe round, so the merged
timeline aligns serving ranks exactly like training ranks.

A replica that dies is the router's business: its dispatches fail, the
router removes it with a routing-table epoch bump and redispatches
(fleet/router.py). ``FleetMember``, the JAX package's recovery loop
that reforms a shared device mesh around a death, waits for the
port's multi-process runtime (ROADMAP queue 1, item 12).
"""

from __future__ import annotations

import inspect
import json
import os
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

from systemml_tpu_torch.fleet import admission
from systemml_tpu_torch.obs import fleet as obs_fleet
from systemml_tpu_torch.obs import trace as obs
from systemml_tpu_torch.obs.metrics import MetricsRegistry
from systemml_tpu_torch.obs.trace import CAT_FLEET
from systemml_tpu_torch.resil import faults, inject

REGISTRY_PREFIX = "replica_r"

# below this many service-time observations the admission gate falls
# back to its conservative floor (mirrors the hedge-floor fallback)
SERVICE_MIN_SAMPLES = 8


def _score_takes_deadline(score: Callable) -> bool:
    """Does this scorer accept the propagated remaining deadline
    (``remaining_s=``)? Detected by SIGNATURE so pre-existing 1-arg
    score callables keep working unchanged."""
    try:
        params = inspect.signature(score).parameters
    except (TypeError, ValueError):
        return False
    return "remaining_s" in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD
        for p in params.values())


class ReplicaUnavailableError(faults.FaultError):
    """This replica cannot serve the request RIGHT NOW — paused past
    the request bound, or the routed generation already retired here
    (a stale routing table mid-rollout). The request itself is fine:
    the handler answers 503 and the router redispatches it to a
    replica that can."""

    fault_kind = faults.WORKER


def registry_path(fleet_dir: str, orig_rank: int) -> str:
    """Per-ORIGINAL-rank registration file — stable across reforms, so
    a renumbered survivor overwrites its own entry, never a peer's."""
    return os.path.join(fleet_dir,
                        f"{REGISTRY_PREFIX}{int(orig_rank):03d}.json")


class ReplicaInfo:
    """One row of the replica registry: identity + endpoints + the
    liveness heartbeat timestamp the router's TTL filter reads."""

    def __init__(self, run_id: str, orig_rank: int, rank: int,
                 generation: int, pid: int, host: str,
                 endpoints: Dict[str, int], wall_ns: int,
                 payload: str = ""):
        self.run_id = run_id
        self.orig_rank = int(orig_rank)
        self.rank = int(rank)
        self.generation = int(generation)
        self.pid = int(pid)
        self.host = host
        self.endpoints = {str(k): int(v) for k, v in endpoints.items()}
        self.wall_ns = int(wall_ns)
        self.payload = payload

    def to_dict(self) -> Dict[str, Any]:
        return {"run_id": self.run_id, "orig_rank": self.orig_rank,
                "rank": self.rank, "generation": self.generation,
                "pid": self.pid, "host": self.host,
                "endpoints": self.endpoints, "wall_ns": self.wall_ns,
                "payload": self.payload}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ReplicaInfo":
        return cls(d["run_id"], d["orig_rank"], d["rank"],
                   d["generation"], d.get("pid", 0),
                   d.get("host", "127.0.0.1"), d.get("endpoints", {}),
                   d.get("wall_ns", 0), d.get("payload", ""))

    def is_live(self, ttl_s: float,
                now_ns: Optional[int] = None) -> bool:
        """Row age under TTL. The age subtracts the WRITER's wall
        clock from the READER's, so ``fleet_liveness_ttl_s`` must
        exceed worst-case inter-host clock skew plus the heartbeat
        cadence — a reader ahead of the writer by more than the TTL
        would see a live replica as dead (and behind it, a dead one as
        live). The NTP-style offsets the subsystem carries
        (obs/fleet.estimate_offsets) are recovered OFFLINE from merged
        shards; the routing hot path cannot consult them, so the TTL
        bound is the contract (documented at the config knob)."""
        now = time.time_ns() if now_ns is None else int(now_ns)
        return (now - self.wall_ns) <= int(float(ttl_s) * 1e9)

    def url(self, prog_gen: int = 0) -> Optional[str]:
        port = self.endpoints.get(str(int(prog_gen)))
        if port is None:
            return None
        return f"http://{self.host}:{port}/score"


def read_registry(fleet_dir: str, ttl_s: Optional[float] = None,
                  note_clocks: bool = True) -> Dict[int, ReplicaInfo]:
    """Live replicas by original rank. Torn/partial JSON (a writer
    mid-``os.replace`` on a slow filesystem) is skipped, stale entries
    are TTL-filtered, and every peer's embedded handshake payload is
    fed to ``obs/fleet.note_peer_ready`` — a registry scan doubles as
    a clock-probe round for the merged timeline."""
    from systemml_tpu_torch.utils.config import get_config

    if ttl_s is None:
        ttl_s = float(get_config().fleet_liveness_ttl_s)
    ident = obs_fleet.identity()
    me = ident.orig_rank if ident is not None else -1
    out: Dict[int, ReplicaInfo] = {}
    try:
        entries = sorted(os.listdir(fleet_dir))
    except OSError:
        return out
    for fn in entries:
        if not (fn.startswith(REGISTRY_PREFIX) and fn.endswith(".json")):
            continue
        try:
            with open(os.path.join(fleet_dir, fn),
                      encoding="utf-8") as fh:
                info = ReplicaInfo.from_dict(json.load(fh))
        except (OSError, ValueError, KeyError):
            continue  # torn write or legacy file: not a live replica
        if not info.is_live(ttl_s):
            continue
        if note_clocks and info.payload and info.orig_rank != me:
            obs_fleet.note_peer_ready(info.orig_rank, info.payload)
        out[info.orig_rank] = info
    return out


class _ScoreHandler(BaseHTTPRequestHandler):
    """POST /score → the replica's scorer for this endpoint's program
    generation. A TRANSIENT failure (paused past the bound, retired
    generation, device loss mid-score) answers 503 — the router treats
    it like a dead target and redispatches. A DETERMINISTIC failure
    (bad payload, programming error) answers 400 — it would fail
    identically on every replica, and a 503 would make the router
    quarantine the whole healthy fleet one redispatch at a time.
    Either way the listener thread never dies with the request."""

    def _remaining_s(self):
        """Remaining deadline budget this request propagated
        (``X-SMTPU-Deadline-Ms``), or None for legacy clients."""
        hdr = self.headers.get(admission.DEADLINE_HEADER)
        if hdr is None:
            return None
        try:
            return float(hdr) / 1000.0
        except ValueError:
            return None

    def _send_429(self, reason: str, retry_after_s: float) -> None:
        # read the request's body first, unparsed: a listener that closes
        # with bytes unread resets the connection, and the client then
        # loses the 429 and sees a dead replica (the router would
        # quarantine a healthy one). A payload of 64 x 1,000 floats is
        # 1.3 MB, more than the socket buffers hold.
        self.rfile.read(int(self.headers.get("Content-Length", "0")))
        body = json.dumps({
            "error": f"admission rejected ({reason})",
            "reason": reason,
            "retry_after_s": round(retry_after_s, 3),
        }).encode("utf-8")
        self.send_response(429)
        self.send_header("Content-Type", "application/json")
        self.send_header("Retry-After", f"{max(0.0, retry_after_s):.3f}")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):  # noqa: N802 (stdlib handler naming)
        if self.path != "/score":
            self.send_error(404)
            return
        gate = getattr(self.server, "smtpu_gate", None)
        remaining_s = self._remaining_s()
        admitted = gate is not None
        if gate is not None:
            try:
                inject.check("fleet.admit")
                reason = gate.try_admit(remaining_s)
            except Exception:  # except-ok: an injected fault at fleet.admit MEANS "shed this request" — it exercises the 429 path without real overload
                reason = admission.REASON_INFLIGHT
            if reason is not None:
                retry_after = gate.retry_after_s()
                on_reject = getattr(self.server, "smtpu_on_reject", None)
                if on_reject is not None:
                    on_reject(reason)
                self._send_429(reason, retry_after)
                return
        try:
            n = int(self.headers.get("Content-Length", "0"))
            req = json.loads(self.rfile.read(n).decode("utf-8"))
            if getattr(self.server, "smtpu_takes_deadline", False):
                resp = self.server.smtpu_score(req,
                                               remaining_s=remaining_s)
            else:
                resp = self.server.smtpu_score(req)
            body = json.dumps(resp).encode("utf-8")
        except Exception as e:  # except-ok: a scoring failure is the ROUTER's problem (503 → redispatch, 400 → propagate); raising here would kill the handler thread and hang the client
            if faults.classify(e) in faults.TRANSIENT:
                self.send_error(503, explain=str(e)[:200])
                return
            # deterministic failure: a compact JSON body so the
            # transport can quote the cause to the caller verbatim
            err = json.dumps({"error": str(e)[:500],
                              "type": type(e).__name__}).encode("utf-8")
            self.send_response(400)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(err)))
            self.end_headers()
            self.wfile.write(err)
            return
        finally:
            if admitted:
                gate.release()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet: obs carries the story
        pass


class ReplicaEndpoint:
    """One HTTP listener serving one program generation's scorer.
    Rolling updates give a replica two of these at once (generation g
    on its original port, g+1 on the generation-indexed schedule)."""

    def __init__(self, score: Callable[[Any], Any], prog_gen: int = 0,
                 port: int = 0, host: str = "127.0.0.1",
                 gate: Optional[admission.AdmissionGate] = None,
                 on_reject: Optional[Callable[[str], None]] = None):
        self.prog_gen = int(prog_gen)
        self.host = host
        self._httpd = ThreadingHTTPServer((host, int(port)),
                                          _ScoreHandler)
        self._httpd.daemon_threads = True
        self._httpd.smtpu_score = score
        self._httpd.smtpu_gate = gate
        self._httpd.smtpu_on_reject = on_reject
        self._httpd.smtpu_takes_deadline = _score_takes_deadline(score)
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"smtpu-replica-g{self.prog_gen}")
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/score"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


class Replica:
    """This process's seat in the serving fleet.

    ``scorer_factory(prog_gen) -> callable(payload) -> outputs`` builds
    the scorer for a program generation — typically closing over a
    ``ScoringService`` (api/serving.py); a rolling update calls it
    again for g+1, and a post-reform ``refresh()`` calls it for every
    live generation (the reform invalidated the old mesh executables).
    Every response carries ``rank`` and ``prog_gen``, so generation
    attribution is inherent, not inferred."""

    def __init__(self, scorer_factory: Callable[[int], Callable],
                 fleet_dir: Optional[str] = None,
                 host: str = "127.0.0.1",
                 registry: Optional[MetricsRegistry] = None):
        from systemml_tpu_torch.utils.config import get_config

        cfg = get_config()
        if fleet_dir is None:
            fleet_dir = cfg.obs_fleet_dir
        if not fleet_dir:
            raise ValueError(
                "Replica needs a fleet directory (argument or config "
                "obs_fleet_dir) — the registry IS the fleet membership")
        self.fleet_dir = str(fleet_dir)
        self.host = host
        self._factory = scorer_factory
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._endpoints: Dict[int, ReplicaEndpoint] = {}
        self._scorers: Dict[int, Callable] = {}
        self._paused = False
        self._hb_stop: Optional[threading.Event] = None
        self._hb_thread: Optional[threading.Thread] = None
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._m_service = self.registry.histogram(
            "fleet_service_seconds", "scorer wall time per admitted "
            "request (the median feeds the admission gate's "
            "predicted-wait estimate)", unit="s")
        self._m_admission_rejects = self.registry.labeled(
            "fleet_admission_rejects_total", "requests shed with 429 "
            "before scoring, by named reason")
        self.gate = admission.AdmissionGate(
            int(cfg.fleet_admission_inflight_max),
            slack=float(cfg.fleet_admission_slack),
            service_time_s=self._service_estimate)
        self.registry.gauge(
            "fleet_admission_inflight", "requests currently admitted "
            "(scoring, or parked on the pause gate)",
            fn=lambda: self.gate.depth)

    def _service_estimate(self) -> float:
        """Median observed scorer wall time; NaN below the sample
        floor so the gate falls back to its conservative
        ``service_floor_s`` (never 0, never NaN downstream)."""
        if self._m_service.count < SERVICE_MIN_SAMPLES:
            return float("nan")
        return self._m_service.quantile(0.5)

    def _note_admission_reject(self, reason: str) -> None:
        """One pre-scoring 429: count it by NAMED reason and land it
        in the overload vocabulary (merged timelines + -stats)."""
        # request-scoped: LabeledCounter carries its own lock
        self._m_admission_rejects[reason] += 1
        admission.emit_overload("fleet_admission_reject", reason=reason,
                                rank=self.orig_rank)

    # ---- identity --------------------------------------------------------

    @staticmethod
    def _ident():
        ident = obs_fleet.identity()
        if ident is not None:
            return (ident.run_id, ident.orig_rank, ident.rank,
                    ident.generation)
        return ("local", 0, 0, 0)

    @property
    def orig_rank(self) -> int:
        return self._ident()[1]

    # ---- serving ---------------------------------------------------------

    def serve(self, prog_gen: int = 0, port: int = 0) -> ReplicaEndpoint:
        """Build (or rebuild) the scorer for ``prog_gen`` and listen.
        Generation 0 is the initial program; a ``prog_gen > 0`` load is
        a rolling-update step and lands in the rollout storyline."""
        g = int(prog_gen)
        scorer = self._factory(g)
        ep = ReplicaEndpoint(
            lambda req, _g=g, remaining_s=None:
                self.score(_g, req, remaining_s=remaining_s),
            prog_gen=g, port=port, host=self.host, gate=self.gate,
            on_reject=self._note_admission_reject)
        with self._lock:
            old = self._endpoints.get(g)
            self._scorers[g] = scorer
            self._endpoints[g] = ep
        if old is not None:
            old.close()
        run_id, orig, rank, gen = self._ident()
        obs.instant("replica_up", CAT_FLEET, orig_rank=orig, rank=rank,
                    gen=g, port=ep.port, pid=os.getpid())
        if g > 0:
            faults.emit("rollout_load", to_gen=g, port=ep.port)
        return ep

    def score(self, prog_gen: int, payload: Any,
              remaining_s: Optional[float] = None) -> Dict[str, Any]:
        """One scoring request. Blocks (bounded) while the replica is
        paused for a reform; a pause that outlives the bound answers
        503 upstream and the router redispatches — the request is never
        lost, only re-homed. A request that propagated a deadline
        (``remaining_s``) waits on the pause gate at most that long:
        work that would be dead on arrival at scoring time fails FAST
        to the redispatch path instead of aging out the full bound."""
        bound = 30.0 if remaining_s is None \
            else max(0.0, min(30.0, float(remaining_s)))
        with self._cv:
            if not self._cv.wait_for(lambda: not self._paused,
                                     timeout=bound):
                raise ReplicaUnavailableError(
                    "replica paused past request bound")
            scorer = self._scorers.get(int(prog_gen))
        if scorer is None:
            raise ReplicaUnavailableError(
                f"no scorer for program generation {int(prog_gen)} "
                f"(retired here, or a stale routing table)")
        run_id, orig, rank, gen = self._ident()
        t0 = time.perf_counter()
        outputs = scorer(payload)
        self._m_service.observe(time.perf_counter() - t0)
        return {"rank": orig, "prog_gen": int(prog_gen),
                "outputs": outputs}

    def pause(self) -> None:
        """Fence scoring (reform in progress): requests park on the
        gate instead of racing a mesh teardown."""
        with self._cv:
            self._paused = True

    def resume(self) -> None:
        with self._cv:
            self._paused = False
            self._cv.notify_all()

    def refresh(self) -> None:
        """Rebuild every live generation's scorer from the factory —
        the post-reform mesh invalidated the old executables."""
        with self._lock:
            gens = sorted(self._scorers)
        for g in gens:
            scorer = self._factory(g)
            with self._lock:
                self._scorers[g] = scorer

    def retire_generation(self, prog_gen: int) -> None:
        """Stop serving ``prog_gen`` (rolling update completed the
        shift away from it) and drop its endpoint + scorer."""
        g = int(prog_gen)
        with self._lock:
            ep = self._endpoints.pop(g, None)
            self._scorers.pop(g, None)
        if ep is not None:
            ep.close()
        faults.emit("rollout_retire", from_gen=g)
        self.heartbeat()

    def endpoints(self) -> Dict[int, int]:
        with self._lock:
            return {g: ep.port for g, ep in self._endpoints.items()}

    # ---- registry / liveness --------------------------------------------

    def register(self, step: int = 0) -> str:
        """Write this replica's registry row atomically (tmp +
        ``os.replace``) under its ORIGINAL rank, embedding the same
        handshake clock payload the training handshake announces."""
        run_id, orig, rank, gen = self._ident()
        info = ReplicaInfo(
            run_id=run_id, orig_rank=orig, rank=rank, generation=gen,
            pid=os.getpid(), host=self.host,
            endpoints={str(g): p for g, p in self.endpoints().items()},
            wall_ns=time.time_ns(),
            payload=obs_fleet.handshake_payload(int(step)))
        path = registry_path(self.fleet_dir, orig)
        # one temporary file per thread: the heartbeat thread and a
        # caller's heartbeat() may write the row at the same moment
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(info.to_dict(), fh)
        os.replace(tmp, path)
        return path

    def heartbeat(self, step: Optional[int] = None) -> None:
        """Refresh the liveness timestamp (and endpoint set) — the
        router's TTL filter treats a stale row as a dead replica."""
        self.register(0 if step is None else int(step))

    def start_heartbeat(self, interval_s: Optional[float] = None
                        ) -> None:
        from systemml_tpu_torch.utils.config import get_config

        if interval_s is None:
            interval_s = float(get_config().fleet_heartbeat_s)
        stop = threading.Event()

        def _beat():
            while not stop.wait(interval_s):
                try:
                    self.heartbeat()
                except OSError:  # except-ok: a missed beat only ages the TTL; the next beat recovers, and dying here would silently stop ALL beats
                    pass

        t = threading.Thread(target=_beat, daemon=True,
                             name="smtpu-replica-heartbeat")
        with self._lock:
            self._hb_stop = stop
            self._hb_thread = t
        t.start()

    def stop_heartbeat(self) -> None:
        with self._lock:
            stop, t = self._hb_stop, self._hb_thread
            self._hb_stop = None
            self._hb_thread = None
        if stop is not None:
            stop.set()
        if t is not None:
            t.join(timeout=5.0)

    def close(self) -> None:
        """Leave the fleet: stop beating, close endpoints, remove the
        registry row. A closed replica ages out of every router's TTL
        view even if the unlink raced a reader."""
        self.stop_heartbeat()
        with self._lock:
            eps = list(self._endpoints.values())
            self._endpoints = {}
            self._scorers = {}
        for ep in eps:
            ep.close()
        run_id, orig, rank, gen = self._ident()
        obs.instant("replica_retire", CAT_FLEET, orig_rank=orig,
                    rank=rank, pid=os.getpid())
        try:
            os.unlink(registry_path(self.fleet_dir, orig))
        except OSError:
            pass


class FleetMember:
    """The recovery loop around a ``Replica`` that reforms a shared
    device mesh when a peer dies (systemml_tpu/fleet/replica.py:544-631,
    over elastic/recover.reform_shared_mesh). It waits for ROADMAP
    queue 1, item 12: constructing one raises, so it never half-runs.
    Without it a death is the router's epoch bump."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "fleet.FleetMember (the mesh reform around a replica death) "
            "waits for ROADMAP queue 1, distributed and elastic (item 12)")


def local_host() -> str:
    """Best-effort routable host name for multi-machine registries;
    single-machine fleets keep the loopback default."""
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"
