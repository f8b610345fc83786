"""The process model of a mesh's world (any product of the dp, pp, sp, tp
and ep axes): one process a rank, rank 0 driving, on ``torch.distributed``.

The JAX package drives every chip from one controller under GSPMD
(``dllama_tpu/parallel/multihost.py``: every host runs the same command
and ``jax.distributed`` joins them into one mesh). PyTorch runs one process
a device, so this package takes the reference's topology instead (a root
and its workers, app.cpp:262-321):

* **Rank 0 drives.** It runs the CLI, the HTTP server and the scheduler,
  and owns the engines a caller sees.
* **Ranks 1..N-1 follow** (:meth:`World.follow`). Each receives, over a
  CPU gloo group of its own, every engine call rank 0 makes (the method's
  name and its host operands, one broadcast a call) and makes the same
  call on its own engine. Engine methods marked :func:`mirrored` are the
  calls that move engine state or touch the device; a call nested in
  another is not sent again. Host-side engine state (positions, slot
  vectors, generator counters) is a function of the calls, so every
  rank's engine stays in the same state without a second protocol, and
  every rank computes the same tokens: the logits are all-gathered in f32
  over tp, a dp replica's tokens (or logits) over dp, and the samplers'
  generators travel with the calls. Rank 0 alone talks to clients.
* **Every call's outcome is checked.** A result that later calls may name
  (an admission, a decode chunk, an engine) lives on a follower exactly as
  long as rank 0 holds its own: rank 0's next message carries the ids of
  the objects it let go. Each message also carries whether rank 0's last
  call raised; a follower whose own outcome differs, or that is named an
  object it does not hold, is out of step and exits non-zero. A call may
  raise and leave the world in step only by an argument or state check
  made before its first exchange (no collective issued, no forward run);
  any other error breaks the world.
* **Local ranks are spawned by the library** (:func:`launch`): one
  process a device, each the child of rank 0's process, with the death
  signal set (``prctl(PR_SET_PDEATHSIG)``), so a worker never outlives its
  driver; a worker also exits when the command channel closes. A caller
  that launches worlds one after another may keep spare ranks started
  ahead (:func:`keep_warm`), each waiting with torch imported.
* **Across hosts** (:func:`initialize`, the CLI's ``--distributed
  --coordinator host:port --num-processes P --process-id I``) every
  process runs the same command; process 0 drives, and its local ranks
  come first. The world is processes x local devices.

Backend rule (:func:`choose_backend`): gloo for CPU tensors; NCCL when
every rank has a card of its own; gloo with the exchange staged through
pinned host memory when ranks share a card, which only a harness builds
(by passing a device a rank). The CLI refuses a mesh larger than the cards
it sees (engine/loader.resolve_mesh).

A dead peer: the driver's death kills its local workers (the death
signal) and closes every worker's channel. A local worker that exits
non-zero breaks the world at once (rank 0 watches its children): a
server then exits non-zero (the JAX package's fail-stop), and so does any
driver under NCCL, whose next collective would wait on the dead rank
forever. A worker on another host is seen only when rank 0's next call
fails, which under NCCL may never happen: no watch spans hosts yet.
"""

from __future__ import annotations

import atexit
import base64
import collections
import ctypes
import datetime
import functools
import hashlib
import importlib
import logging
import os
import pickle
import signal
import subprocess
import sys
import tempfile
import threading
import time
import weakref
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from dllama_tpu_torch.parallel import collectives
from dllama_tpu_torch.parallel.mesh import Mesh, MeshConfig, axis_ranks

log = logging.getLogger("dllama_tpu_torch")

#: the command channel waits as long as a server idles between requests;
#: a peer that dies closes its sockets, which ends the wait at once
CHANNEL_TIMEOUT = datetime.timedelta(days=30)

# multi-host settings (initialize): coordinator "host:port", processes, this process
_DISTRIBUTED: dict | None = None


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join a world across hosts: every host runs the same command with
    ``--coordinator host:port --num-processes P --process-id I``. The
    process group forms when the engine loads (engine/loader.load_model),
    with process 0 at global rank 0; this records the rendezvous. There is
    no metadata to discover them from: all three are required."""
    global _DISTRIBUTED
    if not coordinator or num_processes is None or process_id is None:
        raise ValueError("--distributed needs --coordinator HOST:PORT, --num-processes P "
                         "and --process-id I")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id {process_id} is not in [0, {num_processes})")
    _DISTRIBUTED = {"coordinator": coordinator, "processes": int(num_processes),
                    "process": int(process_id)}
    log.info("distributed: process %d/%d, coordinator %s", process_id, num_processes,
             coordinator)


def distributed() -> dict | None:
    """The settings :func:`initialize` recorded, or None on one host."""
    return _DISTRIBUTED


def choose_backend(devices: list[torch.device]) -> tuple[str, bool]:
    """(backend, staged) for a process's local ranks on `devices`: gloo for
    CPU ranks; NCCL when every rank has a card of its own; gloo staged
    through pinned host memory when ranks share a card."""
    devices = [torch.device(d) for d in devices]
    if all(d.type == "cpu" for d in devices):
        return "gloo", False
    if any(d.type != "cuda" for d in devices):
        raise ValueError(f"a world's ranks are all CPU or all CUDA, got {devices}")
    if len({d.index for d in devices}) == len(devices):
        return "nccl", False
    return "gloo", True


def _set_death_signal(parent: int) -> None:
    """Die with the driver: SIGKILL when the parent exits (Linux), and exit
    now if it already has."""
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        log.warning("prctl(PR_SET_PDEATHSIG) is unavailable; a worker relies on its "
                    "channel closing")
    if os.getppid() != parent:
        os._exit(1)


# ------------------------------------------------------------ mirrored calls


class OutOfStep(RuntimeError):
    """A follower's engines no longer match rank 0's: it exits non-zero."""


class _Ref:
    """A follower-side object named in a call (an admission, a chunk)."""

    def __init__(self, ident: int):
        self.ident = ident


def _keepable(x) -> bool:
    """A call's result that later calls may name: an object with state of
    its own that a weak reference can follow, not a value (numbers,
    arrays, tensors, containers)."""
    return (x is not None and hasattr(x, "__dict__") and type(x).__weakrefoffset__ != 0
            and not isinstance(x, (torch.Tensor, type)) and type(x).__module__ != "numpy")


def _marks(obj) -> tuple[int, int]:
    """What a call has exchanged so far: the collectives this process
    issued and the forwards `obj` ran (a graph's replay is a forward)."""
    return collectives.issued(), getattr(obj, "forwards", 0)


def _settled(e: Exception, obj, mark) -> bool:
    """Whether a call that raised `e` left the world in step: an argument
    or state check that every rank makes alike, raised before the call's
    first exchange. A collective's or a capture's error, or any error after
    an exchange, is not."""
    if isinstance(e, (dist.DistError, OutOfStep)) or _marks(obj) != mark:
        return False
    return isinstance(e, (ValueError, KeyError, IndexError, NotImplementedError)) or \
        type(e).__module__.startswith("dllama_tpu_torch.engine")


class Link:
    """Rank 0's end of the command channel. One lock orders every mirrored
    call, so the followers see them in the order rank 0 makes them."""

    def __init__(self, group, digest):
        self.group = group
        self.lock = threading.RLock()
        self.local = threading.local()
        self.next_id = 1
        self.closed = False
        self.digest = digest  # the world's digest of the calls' token results
        self.live: set[int] = set()  # ids of the named objects rank 0 holds
        self.dropped = collections.deque()  # ids of named objects rank 0 let go
        self.last: tuple[int, bool] | None = None  # (id, raised) of the last call or build
        # a broken world ends the process (the CLI's fail-stop) instead of
        # raising to a caller that could go on serving from one rank
        self.fail_stop = False

    @property
    def depth(self) -> int:
        return getattr(self.local, "depth", 0)

    def _encode(self, x):
        ident = getattr(x, "_mesh_id", None)
        if ident is not None:
            return _Ref(ident)
        if isinstance(x, (list, tuple)):
            return type(x)(self._encode(v) for v in x)
        if isinstance(x, dict):
            return {k: self._encode(v) for k, v in x.items()}
        return x

    def name(self, obj, ident: int) -> None:
        """Give `obj` the id the followers keep theirs under; when this one
        goes, the next message drops theirs."""
        obj._mesh_id = ident
        self.live.add(ident)
        weakref.finalize(obj, self._let_go, ident).atexit = False

    def _let_go(self, ident: int) -> None:
        self.live.discard(ident)
        self.dropped.append(ident)

    def send(self, op: str, body: tuple = ()) -> None:
        """One message: the op and its body, the ids let go since the last
        message, and the outcome of the last call."""
        if self.closed:
            raise RuntimeError("the mesh's command channel is closed")
        drops = []
        while self.dropped:
            drops.append(self.dropped.popleft())
        dist.broadcast_object_list([(op, body, drops, self.last)], src=0, group=self.group)

    def broken(self, e: Exception, stop: bool = False) -> None:
        """A call failed in its exchange (a peer died, a collective or a
        capture failed): the ranks are out of step for good. The process
        ends under the fail-stop or when `stop`."""
        self.closed = True
        log.critical("mesh: the world is broken (%r); no further call is made", e)
        if self.fail_stop or stop:
            logging.shutdown()
            os._exit(1)

    def call(self, obj, name: str, fn: Callable, args, kwargs):
        """Send ``obj.name(*args, **kwargs)`` to the followers, then make it
        here; a result later calls may name gets the id the followers keep
        theirs under."""
        with self.lock:
            ret_id = self.next_id
            self.next_id += 1
            self.local.depth = self.depth + 1
            mark = _marks(obj)
            try:
                self.send("call", (obj._mesh_id, name, self._encode(args),
                                   self._encode(kwargs), ret_id))
                out = fn(obj, *args, **kwargs)
            except Exception as e:
                self.last = (ret_id, True)
                if not _settled(e, obj, mark):
                    self.broken(e)
                raise
            finally:
                self.local.depth -= 1
            self.last = (ret_id, False)
            _fold(self.digest, out)
            if _keepable(out):
                self.name(out, ret_id)
            return out


def _fold(digest, out) -> None:
    """Fold a call's token result (an int array or an int) into a rank's
    running digest; other results are skipped."""
    if isinstance(out, np.ndarray) and out.dtype.kind in "iu":
        digest.update(np.ascontiguousarray(out, dtype=np.int64).tobytes())
    elif isinstance(out, (int, np.integer)) and not isinstance(out, bool):
        digest.update(str(int(out)).encode())


def mirrored(fn: Callable) -> Callable:
    """Mark an engine method as a call every rank makes: on rank 0 of a
    world it is sent to the followers first (engine objects there carry
    ``_mesh_link``); anywhere else, and nested in another mirrored call, it
    runs as it is."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        link = self.__dict__.get("_mesh_link")
        if link is None or link.depth:
            return fn(self, *args, **kwargs)
        return link.call(self, fn.__name__, fn, args, kwargs)

    wrapper.mirrored = True
    return wrapper


def refuse_on_mesh(obj, what: str) -> None:
    """Raise (before anything is sent) for a call this package does not carry
    on a mesh: a follower's recovery would need a design of its own."""
    if getattr(obj, "exchange", None) is not None:
        from dllama_tpu_torch.parallel.mesh import NotPorted

        raise NotPorted(f"{what} on a mesh")


# ------------------------------------------------------------------ factories


def _make(kind: str, base, kwargs: dict):
    """Another engine over the base engine's weights on this rank: ``batch``
    (a BatchEngine) or ``engine`` (an InferenceEngine)."""
    common = dict(device=base.device, shardings=base.shardings)
    if kind == "batch":
        from dllama_tpu_torch.engine.batch import BatchEngine

        return BatchEngine(base.shardings.cfg, base.params, **dict(common, **kwargs))
    if kind == "engine":
        from dllama_tpu_torch.engine.engine import InferenceEngine

        return InferenceEngine(base.shardings.cfg, base.params, **dict(common, **kwargs))
    raise ValueError(f"unknown engine kind {kind!r}")


class World:
    """One rank's handle on the world: its :class:`Mesh`, the base engine
    its build made, and on rank 0 the command channel (``driver``)."""

    def __init__(self, mesh: Mesh, engine, cmd_group, children=(), files=()):
        self.mesh = mesh
        self.rank = mesh.rank
        self.engine = engine
        self.cmd_group = cmd_group
        self.children = list(children)
        self.files = list(files)
        self.digest = hashlib.sha1()  # of every call's token results (rank_digest)
        self.link = Link(cmd_group, self.digest) if self.rank == 0 else None
        if self.link is not None:
            engine._mesh_id = 0
            engine._mesh_link = self.link
        self.objects: dict[int, object] = {0: engine}  # a follower's named objects
        self.last: tuple[int, bool] | None = None  # a follower's (id, raised) of its last call
        self.build_s = 0.0  # seconds this rank's engine build took (_join)

    @property
    def driver(self) -> bool:
        return self.rank == 0

    # -------------------------------------------------------------- rank 0

    def make(self, kind: str, **kwargs):
        """Build another engine on every rank over the resident weights
        (``kind``: "batch" or "engine"); returns rank 0's, which drives.
        Rank 0 builds first (a build exchanges nothing), so a refusal sends
        nothing."""
        with self.link.lock:
            obj = _make(kind, self.engine, kwargs)
            ident = self.link.next_id
            self.link.next_id += 1
            self.link.send("new", (kind, kwargs, ident))
            self.link.last = (ident, False)
            self.link.name(obj, ident)
            obj._mesh_link = self.link
            return obj

    def call_all(self, name: str, *args) -> list:
        """A rank function of this module (:func:`rank_report`,
        :func:`rank_launches`, :func:`rank_digest`, :func:`rank_objects`,
        :func:`rank_cache`) on every rank, the results in rank order."""
        if name not in RANK_FUNCTIONS:
            raise ValueError(f"{name!r} is not one of {RANK_FUNCTIONS}")
        with self.link.lock:
            self.link.send("fn", (name, args))
            mine = globals()[name](self, *args)
            out = [None] * self.mesh.size
            dist.gather_object(mine, out, dst=0, group=self.cmd_group)
            return out

    def close(self, timeout: float = 30.0) -> None:
        """Stop the followers, wait for the local ones, leave the group, and
        let go of the engines (the exit hook holds this world until then).
        Safe to call twice."""
        atexit.unregister(self.close)
        self.objects.clear()
        link = self.link
        if link is not None and not link.closed and link.lock.acquire(timeout=timeout):
            try:  # after any call in flight on another thread
                link.send("stop")
            except Exception as e:  # a dead peer: the children are reaped below
                log.warning("mesh: stopping the followers failed: %s", e)
            finally:
                link.closed = True
                link.lock.release()
        for p in self.children:
            try:
                p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self.children = []
        if dist.is_initialized():
            dist.destroy_process_group()
        for f in self.files:
            try:
                os.remove(f)
            except OSError:
                pass
        self.files = []

    # ------------------------------------------------------------- followers

    def _resolve(self, x):
        if isinstance(x, _Ref):
            if x.ident not in self.objects:
                raise OutOfStep(f"mesh rank {self.rank}: rank 0 named object {x.ident}, "
                                "which this rank does not hold")
            return self.objects[x.ident]
        if isinstance(x, (list, tuple)):
            return type(x)(self._resolve(v) for v in x)
        if isinstance(x, dict):
            return {k: self._resolve(v) for k, v in x.items()}
        return x

    def follow(self) -> int:
        """The follower loop (no JAX counterpart: JAX's one controller needs
        none): receive rank 0's calls and make them here until it stops or
        its channel closes. Returns the process's exit code; raises
        :class:`OutOfStep` (or the call's own error) when this rank can no
        longer follow, which ends it non-zero."""
        while True:
            box = [None]
            try:
                dist.broadcast_object_list(box, src=0, group=self.cmd_group)
            except Exception as e:  # the driver is gone: nothing to follow
                log.info("mesh rank %d: command channel closed (%s)", self.rank, e)
                return 0
            op, body, drops, last = box[0]
            if last != self.last:
                raise OutOfStep(f"mesh rank {self.rank}: the last call (id, raised) was "
                                f"{last} on rank 0 and {self.last} here")
            for ident in drops:
                self.objects.pop(ident, None)
            if op == "stop":
                if dist.is_initialized():
                    dist.destroy_process_group()
                return 0
            if op == "fn":
                name, args = body
                dist.gather_object(globals()[name](self, *args), None, dst=0,
                                   group=self.cmd_group)
                continue
            if op == "new":
                kind, build_kw, ret_id = body
                obj, args, kwargs = None, (), {}
                fn = functools.partial(_make, kind, self.engine, build_kw)
            else:
                ident, name, args, kwargs, ret_id = body
                obj = self._resolve(_Ref(ident))
                fn = getattr(obj, name)
                args, kwargs = self._resolve(args), self._resolve(kwargs)
            mark = _marks(obj)
            try:
                out = fn(*args, **kwargs)
            except Exception as e:
                if not _settled(e, obj, mark):
                    raise
                # rank 0 raised the same, before any exchange: its next
                # message says so, or this rank is out of step
                log.debug("mesh rank %d: call %d raised %r", self.rank, ret_id, e)
                self.last = (ret_id, True)
                continue
            self.last = (ret_id, False)
            if op == "call":
                _fold(self.digest, out)
            if op == "new" or _keepable(out):
                self.objects[ret_id] = out


def rank_report(world) -> dict:
    """One rank's load and memory: its parameter bytes, the bytes its
    caching allocator holds on its card (0 on the CPU), the lazy Q40 bytes
    it decoded and the seconds that took, and the seconds its build took."""
    from dllama_tpu_torch.models.formats import LAZY_DECODE
    from dllama_tpu_torch.utils.profiling import params_nbytes

    eng = world.engine
    return {"rank": world.rank, "device": str(eng.device),
            "param_bytes": params_nbytes(eng.params),
            "allocated_bytes": (torch.cuda.memory_allocated(eng.device)
                                if eng.device.type == "cuda" else 0),
            "lazy_decode_bytes": LAZY_DECODE["bytes"],
            "lazy_decode_s": LAZY_DECODE["seconds"], "build_s": world.build_s}


def rank_launches(world, reset: bool = False) -> dict:
    """One rank's kernel launch counts (every wrapper's table), zeroed after
    the read when `reset`."""
    from dllama_tpu_torch.engine.graphs import launch_tables

    out = {}
    for table in launch_tables():
        out.update(table)
        if reset:
            for k in table:
                table[k] = 0
    return out


def rank_digest(world) -> str:
    """One rank's digest of the token results of every mirrored call so far:
    equal on every rank when every rank computed the same tokens (the
    check that the world stayed in step)."""
    return world.digest.hexdigest()


def rank_objects(world) -> int:
    """How many named objects one rank holds for later calls (rank 0: its
    live objects the followers hold too): equal on every rank."""
    if world.driver:  # those let go since the last message count until it
        return 1 + len(world.link.live) + len(world.link.dropped)
    return len(world.objects)


def rank_cache(world) -> dict:
    """One rank's base-engine KV cache on the host (k and v, the rank's
    rows of its kv heads, an sp rank's trash row last) with its mesh
    coordinates: for checks at small shapes; the copy is the whole cache."""
    eng = world.engine
    return {"rank": world.rank, "coords": world.mesh.coords,
            "k": eng.cache.k.detach().to("cpu", copy=True),
            "v": eng.cache.v.detach().to("cpu", copy=True)}


RANK_FUNCTIONS = ("rank_report", "rank_launches", "rank_digest", "rank_objects",
                  "rank_cache")


# ------------------------------------------------------------------- launching


def launch(build: str, kwargs: dict, config: MeshConfig, device="cpu",
           devices: list | None = None, rendezvous: str | None = None) -> World:
    """Form the world of `config` and build each rank's engine with
    ``build`` ("module:function", called as ``fn(mesh, device, **kwargs)``
    on every rank, rank 0 here). This process's local ranks are spawned
    here; on one host that is every rank. ``devices``: one a local rank
    (default: ``cuda:i`` a rank when ``device`` is a CUDA device, else the
    CPU for each). ``rendezvous``: the init method (default: a fresh file
    under the temporary directory; across hosts ``tcp://`` the
    coordinator). Returns this process's :class:`World`: on global rank 0
    the driver, elsewhere a follower (call :meth:`World.follow`)."""
    multi = distributed()
    processes = multi["processes"] if multi else 1
    process = multi["process"] if multi else 0
    if config.n_devices % processes:
        raise ValueError(f"mesh of {config.n_devices} ranks over {processes} processes")
    n_local = config.n_devices // processes
    if devices is None:
        kind = torch.device(device).type
        devices = ([torch.device("cuda", i) for i in range(n_local)] if kind == "cuda"
                   else [torch.device("cpu")] * n_local)
    devices = [torch.device(d) for d in devices]
    if len(devices) != n_local:
        raise ValueError(f"{len(devices)} devices for {n_local} local ranks")
    backend, staged = choose_backend(devices)
    files = []
    if multi:
        rendezvous = f"tcp://{multi['coordinator']}"
    elif rendezvous is None:
        fd, path = tempfile.mkstemp(prefix="dllama-mesh-")
        os.close(fd)
        os.remove(path)  # the file store makes it
        rendezvous = f"file://{path}"
        files.append(path)
    base = process * n_local
    spec = {"build": build, "kwargs": kwargs, "config": config, "backend": backend,
            "staged": staged, "rendezvous": rendezvous, "world": config.n_devices,
            "parent": os.getpid()}
    children = []
    for i in range(1, n_local):
        rank_spec = dict(spec, rank=base + i, device=str(devices[i]))
        children.append(_start_rank(base64.b64encode(pickle.dumps(rank_spec)).decode()))
    _top_up()
    try:
        world = _join(dict(spec, rank=base, device=str(devices[0])))
    except BaseException:
        for p in children:
            p.kill()
        raise
    world.children = children
    world.files = files
    if world.driver:
        atexit.register(world.close)
        if children:
            threading.Thread(target=_watch, args=(world,), name="mesh-watch",
                             daemon=True).start()
    return world


#: the module a local rank's process runs
MODULE = "dllama_tpu_torch.parallel.multihost"
#: local ranks started ahead of a launch (keep_warm): each has imported
#: torch and this package and waits on its stdin for its rank's payload
_SPARES: list[subprocess.Popen] = []
_WARM = [0]


def keep_warm(n: int) -> None:
    """Keep `n` local ranks started ahead of the next :func:`launch`, which
    hands its ranks to them before it starts any of its own and then
    starts `n` more. A rank's process spends seconds importing torch; a
    caller that launches worlds one after another (a test harness) hides
    that behind its own work. ``keep_warm(0)`` ends the spares; so does
    this process's exit (each reads EOF)."""
    _WARM[0] = n
    _top_up()


def _rank_env() -> dict:
    """A local rank's environment: this one, with the package's root first
    on PYTHONPATH."""
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


def _start_rank(payload: str) -> subprocess.Popen:
    """A local rank's process for `payload`: a spare started in this same
    environment where there is one, else a new process."""
    env = _rank_env()
    while _SPARES:
        p = _SPARES.pop(0)
        if p.poll() is None and p.rank_env == env:
            try:
                p.stdin.write(payload.encode() + b"\n")
                p.stdin.close()
                return p
            except OSError:
                pass
        _end_spare(p)
    return subprocess.Popen([sys.executable, "-m", MODULE, payload],
                            stdin=subprocess.DEVNULL, stdout=sys.stderr.fileno(), env=env)


def _end_spare(p: subprocess.Popen) -> None:
    try:
        p.stdin.close()  # EOF: the spare exits
        p.wait(timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        p.kill()
        p.wait()


def _top_up() -> None:
    """Start or end spares until keep_warm's count of them waits."""
    _SPARES[:] = [p for p in _SPARES if p.poll() is None]
    while len(_SPARES) > _WARM[0]:
        _end_spare(_SPARES.pop())
    while len(_SPARES) < _WARM[0]:
        env = _rank_env()
        p = subprocess.Popen([sys.executable, "-m", MODULE, "-"], stdin=subprocess.PIPE,
                             stdout=sys.stderr.fileno(), env=env)
        p.rank_env = env
        _SPARES.append(p)


@atexit.register
def _end_spares() -> None:
    keep_warm(0)


def _watch(world: World, every_s: float = 0.2) -> None:
    """Rank 0's watch over its local followers: one that exits non-zero
    while the world is open breaks it. Under NCCL the driver's next
    collective would wait on that rank forever, so the process ends."""
    link = world.link
    while not link.closed:
        for p in list(world.children):
            code = p.poll()
            if code not in (None, 0) and not link.closed:
                link.broken(RuntimeError(f"mesh: a local rank (pid {p.pid}) exited with "
                                         f"{code}"), stop=world.mesh.backend == "nccl")
                return
        time.sleep(every_s)


#: the axes whose process groups every rank makes, in this order
GROUP_AXES = ("dp", "sp", "tp", "pp", "ep")


def make_groups(config: MeshConfig, rank: int) -> dict:
    """This rank's process group on each axis: the default group
    where the axis spans the world (a world of one rank included, whose tp
    exchange then runs over itself), None on another axis of one. Every
    rank calls ``dist.new_group`` for every group of every axis, in one
    fixed order (GROUP_AXES, then parallel/mesh.axis_ranks's), as the call
    requires of all ranks: a rank that skipped one would hang the world."""
    out = {}
    for ax in GROUP_AXES:
        if getattr(config, ax) == config.n_devices:
            out[ax] = dist.group.WORLD
            continue
        if getattr(config, ax) == 1:
            out[ax] = None
            continue
        for ranks in axis_ranks(config, ax):
            group = dist.new_group(ranks=ranks, timeout=CHANNEL_TIMEOUT)
            if rank in ranks:
                out[ax] = group
    return out


def _join(spec: dict) -> World:
    """Init this rank's process group, build its engine, return its World."""
    rank, device = spec["rank"], torch.device(spec["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(spec["backend"], init_method=spec["rendezvous"], rank=rank,
                            world_size=spec["world"], timeout=CHANNEL_TIMEOUT)
    # a group of its own, so a message can never pair with an exchange
    cmd_group = dist.new_group(backend="gloo", timeout=CHANNEL_TIMEOUT)
    groups = make_groups(spec["config"], rank)
    mesh = Mesh(spec["config"], rank, groups.get("tp"), spec["backend"], spec["staged"],
                groups)
    if spec["backend"] == "nccl":
        # every communicator exists before any capture records a collective:
        # each rank warms its groups axis by axis, in the order they were made
        warm = torch.zeros(1, device=device)
        for ax in GROUP_AXES:
            if groups.get(ax) is not None:
                dist.all_reduce(warm, group=groups[ax])
        torch.cuda.synchronize(device)
    module, _, name = spec["build"].partition(":")
    fn = getattr(importlib.import_module(module), name)
    from dllama_tpu_torch.models.formats import LAZY_DECODE

    LAZY_DECODE.update(bytes=0, seconds=0.0)  # rank_report reads this build's
    t0 = time.perf_counter()
    engine = fn(mesh, device, **spec["kwargs"])
    world = World(mesh, engine, cmd_group)
    world.build_s = time.perf_counter() - t0
    return world


def _rank_main(payload: str) -> int:
    """A spawned local rank: join, build, follow."""
    spec = pickle.loads(base64.b64decode(payload))
    _set_death_signal(spec["parent"])
    torch.set_num_threads(1)
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr,
                        format=f"[rank {spec['rank']}] %(levelname)s %(message)s")
    world = _join(spec)
    return world.follow()


# ------------------------------------------------------------- tree engines


def tree_engine(mesh: Mesh, device, path: str, engine_kw: dict):
    """A rank's InferenceEngine from a full parameter tree saved at `path`
    (:func:`launch_tree`): the rank keeps its shard."""
    from dllama_tpu_torch.engine.engine import InferenceEngine
    from dllama_tpu_torch.parallel.sharding import LlamaShardings

    saved = torch.load(path, map_location="cpu", weights_only=False)
    sh = LlamaShardings(mesh, saved["cfg"])
    return InferenceEngine(saved["cfg"], saved["params"], shardings=sh, device=device,
                           **engine_kw)


def launch_tree(cfg, params: dict, config: MeshConfig, directory: str, devices=None,
                **engine_kw) -> World:
    """A world whose ranks hold the shards of an in-memory parameter tree
    (``params`` full, on the CPU): the tree is saved once under `directory`,
    each rank loads it and keeps its shard. ``engine_kw`` goes to every
    rank's InferenceEngine (sync, cache_dtype, ...)."""
    path = os.path.join(directory, "mesh-params.pt")
    torch.save({"cfg": cfg, "params": params}, path)
    rdv = os.path.join(directory, "mesh-rendezvous")
    if os.path.exists(rdv):
        os.remove(rdv)
    return launch("dllama_tpu_torch.parallel.multihost:tree_engine",
                  {"path": path, "engine_kw": engine_kw}, config, devices=devices,
                  rendezvous=f"file://{rdv}")


if __name__ == "__main__":
    # run as the package's module, not as __main__: the objects rank 0
    # pickles name this module's classes (_Ref)
    from dllama_tpu_torch.parallel import multihost

    payload = sys.argv[1]
    if payload == "-":  # a spare (keep_warm): torch is imported; wait for a rank
        import dllama_tpu_torch.engine.loader  # noqa: F401  (the usual build)

        payload = sys.stdin.readline().strip()
        if not payload:  # let go unused
            raise SystemExit(0)
    raise SystemExit(multihost._rank_main(payload))
