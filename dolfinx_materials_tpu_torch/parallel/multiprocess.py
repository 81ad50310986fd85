"""Multi-process runs of the fused steps: one process a rank, one device a rank.

Counterpart of dolfinx_materials_tpu/parallel/multiprocess.py. The reference
scales by MPI ranks that each own their cells; the JAX package launches one
controller a process and lets ``jax.distributed`` join them into one mesh.
Here each process joins a ``torch.distributed`` process group and runs the
port's steps on its share of the cells; the sums across ranks are
``all_reduce`` calls on the group:

- :func:`initialize`: this process's bring-up (NCCL on its card, or gloo on
  the CPU or on a card that several ranks share);
- :func:`global_device_mesh`: the :class:`~.sharding.DeviceMesh` over the
  group's ranks, outer axis first;
- :func:`allgather`: a tensor in full on every rank;
- :func:`launch`: a launcher of N worker processes on this host;
- :func:`exit_worker`: the end of a worker process.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

#: this process's device, set by :func:`initialize`
_LOCAL = {}


def pick_free_port() -> int:
    """A free TCP port on localhost for the process group's store."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _init_method(coordinator: str) -> str:
    if coordinator.startswith(("file://", "tcp://")):
        return coordinator
    return f"tcp://{coordinator}"


def initialize(process_id, num_processes, coordinator, device=None, backend=None, threads=1):
    """Join this process to a group of ``num_processes`` ranks as rank
    ``process_id``; returns this rank's ``torch.device``.

    ``coordinator`` is ``"host:port"`` (a TCP store on rank 0) or a
    ``file://`` path that every rank can reach. ``device=None`` takes the
    card ``cuda:{process_id % device_count}`` (under NCCL rank r's own
    ``cuda:r``) and raises without one, as
    :func:`~dolfinx_materials_tpu_torch.resolve_device` does; ``"cpu"``
    runs on the CPU. ``backend`` defaults to NCCL on a card and gloo on the
    CPU; ``backend="gloo"`` on a card lets ranks share one card. NCCL
    refuses two ranks on one device, so more NCCL ranks than visible cards
    raise ``ValueError`` here, before any card or group is touched.
    ``threads``: torch's intra-op threads in this process (``None`` leaves
    them)."""
    import torch.distributed as dist

    from .. import resolve_device

    pid, nproc = int(process_id), int(num_processes)
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        ncards = torch.cuda.device_count()
        if backend == "nccl" and nproc > ncards:
            raise ValueError(
                f"rank {pid} of {nproc}: {nproc} NCCL ranks need {nproc} cards, and "
                f"torch.cuda.device_count() is {ncards}; run at most {ncards} ranks, one a card "
                "(backend='gloo' lets ranks share a card)")
        dev = torch.device("cuda", pid % ncards if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    if threads is not None:
        torch.set_num_threads(int(threads))
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=_init_method(coordinator), world_size=nproc, rank=pid, **kw)
    _LOCAL["device"] = dev
    return dev


def local_device() -> torch.device:
    """This rank's device (after :func:`initialize`)."""
    if "device" not in _LOCAL:
        raise RuntimeError("no process group: call multiprocess.initialize first")
    return _LOCAL["device"]


def global_device_mesh(axis=("dcn", "ici"), shape=None):
    """The mesh over every rank of the group, outer axis first: ``axis`` a
    name or a tuple of names, ``shape`` their sizes (default: all ranks on
    the last axis). Rank r sits at the row-major position r."""
    import torch.distributed as dist

    from .sharding import DeviceMesh

    n = dist.get_world_size()
    names = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
    sizes = tuple(int(s) for s in shape) if shape is not None else (1,) * (len(names) - 1) + (n,)
    if len(sizes) != len(names) or int(np.prod(sizes)) != n:
        raise ValueError(f"mesh shape {sizes} over axes {names} does not hold the group's {n} ranks")
    devs = [None] * n
    dist.all_gather_object(devs, str(local_device()))
    arr = np.empty(n, dtype=object)
    arr[:] = [torch.device(d) for d in devs]
    return DeviceMesh(arr.reshape(sizes), names, group=dist.group.WORLD, rank=dist.get_rank())


def allgather(x):
    """``x`` in full on every rank: the steps of :mod:`.sharding` and
    :mod:`.blocked` take and return whole tensors on every rank (they join
    the ranks' blocks themselves), so this is the identity on a tensor, and
    the JAX workers' ``allgather(u)[:ndofs]`` carries over."""
    return torch.as_tensor(x)


def exit_worker(code=0):
    """End this worker process once its results are written: the group's
    ranks meet at a barrier, then the process exits with ``code`` through
    ``os._exit``, leaving the process group to the operating system.
    Tearing down NCCL communicators between cards (``destroy_process_group``,
    or the interpreter's exit that runs it) can hang after every collective
    has completed: it did for two ranks on two H100s under the gVisor
    container runtime, whatever NCCL's transport."""
    import torch.distributed as dist

    dist.barrier()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(int(code))


def launch(worker_argv, num_processes, timeout=900.0, env_extra=None, cwd=None, coordinator=None):
    """Run ``num_processes`` workers of ``worker_argv`` on this host and wait
    for them.

    Each worker gets three more arguments, ``process_id num_processes
    coordinator`` (``coordinator`` as given, else ``127.0.0.1:<free port>``),
    and ``OMP_NUM_THREADS=1`` and ``PYTHONUNBUFFERED=1`` in its environment
    (``env_extra`` may set either): what a worker printed reaches its file at
    once, so a worker that is killed keeps its output. A worker that exits
    non-zero ends the others at once; at ``timeout`` seconds every worker
    still running is killed. Returns the workers' outputs (stdout and stderr
    together); raises ``RuntimeError`` with every worker's last output when
    any worker failed."""
    coord = coordinator or f"127.0.0.1:{pick_free_port()}"
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONUNBUFFERED"] = "1"
    if env_extra:
        env.update(env_extra)
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(num_processes)]
    procs = [subprocess.Popen(list(worker_argv) + [str(pid), str(num_processes), coord], stdout=logs[pid],
                              stderr=subprocess.STDOUT, text=True, env=env, cwd=cwd)
             for pid in range(num_processes)]
    deadline = time.time() + timeout
    timed_out = False
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.time() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    rcs = [p.returncode for p in procs]
    if timed_out or any(rc != 0 for rc in rcs):
        report = "\n".join(f"--- worker {i} (rc={rcs[i]}) ---\n{outs[i][-4000:]}" for i in range(num_processes))
        why = f"timed out after {timeout:g}s" if timed_out else "a worker failed"
        raise RuntimeError(f"multi-process launch {why}:\n{report}")
    return outs
