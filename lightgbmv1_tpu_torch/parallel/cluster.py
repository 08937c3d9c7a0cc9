"""The cluster bring-up of the parallel learners over ``torch.distributed``.

Port of lightgbmv1_tpu/parallel/cluster.py: ``parse_machine_list``
(:100), rank discovery (:107, ``discover_rank``), ``init_cluster``
(:133) and ``make_mesh`` (:211).  The JAX package brings up
``jax.distributed`` and spans one device mesh across the processes; here
``init_cluster`` makes the default ``torch.distributed`` process group
over ``tcp://machines[0]`` (the reference's ``Network::Init``,
src/network/network.cpp:30, with the socket linker's machine list), and
``make_mesh`` is that group (``parallel/collectives.Group``) with its
world size.  The knobs are the reference's: ``machines`` (a
``host:port`` list, the first the coordinator) or
``machine_list_filename`` (one ``host port`` or ``host:port`` a line),
``num_machines``, ``local_listen_port``, and ``time_out`` in minutes.

Rank discovery differs by design.  The JAX ``discover_rank`` claims a
local entry by binding its port and closing the socket at once, so two
processes on one host may both see the first port free and both take
rank 0.  The port finds itself as the reference's socket linker does
(src/network/linkers_socket.cpp): the entry whose host is a local
address and whose port is this process's ``local_listen_port``; it binds
that port and keeps it bound until the group is up, so a second process
configured with the same port fails instead of sharing a rank.  Rank 0's
port is the coordinator's: its claim is released just before the group's
store binds it.

The coordinator bootstrap is retried ``bootstrap_retries`` times with the
JAX package's seeded, jittered exponential backoff (:176-203): a
coordinator a beat late to bind costs a retry, not the run.  The backend
is ``collectives.backend_for``'s, chosen once from the topology: NCCL
where every rank has a card of its own, gloo otherwise (the CPU, or ranks
sharing one card).
"""

from __future__ import annotations

import datetime
import random
import socket
import time
from typing import List, Optional, Tuple

import torch

from ..config import Config
from ..utils.log import log_fatal, log_info, log_warning
from .collectives import Group, backend_for, current_group


def find_free_port(host: str = "127.0.0.1") -> int:
    """A TCP port free now (released before returning)."""
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, 0))
        return int(s.getsockname()[1])


def _local_addresses() -> List[str]:
    addrs = {"127.0.0.1", "localhost", "0.0.0.0"}
    try:
        hostname = socket.gethostname()
        addrs.add(hostname)
        addrs.add(socket.gethostbyname(hostname))
    except OSError:
        pass
    return list(addrs)


def parse_machine_list(spec: str) -> List[str]:
    """The ``host:port`` entries of a ``machines`` value or a machine-list
    file's text (comma- or newline-separated; a ``host port`` line is
    read as ``host:port``)."""
    entries = []
    for m in spec.replace("\n", ",").split(","):
        m = m.strip()
        if not m:
            continue
        parts = m.split()
        entries.append(f"{parts[0]}:{parts[1]}" if len(parts) == 2 else m)
    return entries


def _host_port(entry: str) -> Tuple[str, int]:
    host, _, port = entry.rpartition(":")
    if not host or not port.isdigit():
        log_fatal(f"machine list entry {entry!r}: expected host:port")
    return host, int(port)


def discover_rank(machines: List[str], local_listen_port: int
                  ) -> Tuple[int, socket.socket]:
    """This process's rank: the entry whose host is a local address and
    whose port is ``local_listen_port`` (the reference socket linker's
    rule).  Returns the rank and a socket bound to that port, which the
    caller holds until the group is up."""
    local = set(_local_addresses())
    mine = [i for i, m in enumerate(machines)
            if _host_port(m)[0] in local
            and _host_port(m)[1] == int(local_listen_port)]
    if not mine:
        log_fatal(f"Could not find the local machine in the machines list "
                  f"(no local entry with local_listen_port="
                  f"{local_listen_port}): {machines}")
    if len(mine) > 1:
        log_fatal(f"machines lists the local port {local_listen_port} "
                  f"{len(mine)} times: {machines}")
    claim = socket.socket()
    try:
        claim.bind(("", int(local_listen_port)))
    except OSError as e:
        claim.close()
        log_fatal(f"local_listen_port={local_listen_port} is taken "
                  f"({e}): another process holds this rank")
    return mine[0], claim


def _machines_of(config: Config) -> List[str]:
    if config.machines:
        return parse_machine_list(config.machines)
    if config.machine_list_filename:
        from ..utils.fileio import open_file

        with open_file(config.machine_list_filename) as fh:
            return parse_machine_list(fh.read())
    return []


def init_cluster(config: Optional[Config] = None, *,
                 coordinator_address: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None,
                 device=None, bootstrap_retries: int = 3,
                 bootstrap_backoff_s: float = 0.5) -> Group:
    """Make the default process group and return it (JAX :133).  With a
    ``Config`` naming ``machines`` (or ``machine_list_filename``) the
    reference's semantics apply: the world is the list, the coordinator
    its first entry, the rank ``discover_rank``'s; or give
    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id``.  ``device``: the training device (its type picks the
    backend; on the card NCCL ranks bind card ``rank % device_count``).
    A second call returns the group made by the first."""
    import torch.distributed as dist

    if dist.is_initialized():
        log_warning("init_cluster called twice; ignoring")
        return current_group()
    claim = None
    machines = _machines_of(config) if config is not None else []
    if machines:
        if config.num_machines > 1 and len(machines) != config.num_machines:
            log_fatal(f"machines lists {len(machines)} hosts but "
                      f"num_machines={config.num_machines}")
        coordinator_address = machines[0]
        num_processes = len(machines)
        process_id, claim = discover_rank(machines,
                                          config.local_listen_port)
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        log_fatal("init_cluster needs machines=host:port,... (or "
                  "machine_list_filename) or coordinator_address, "
                  "num_processes and process_id")
    minutes = config.time_out if config is not None else 0
    timeout = datetime.timedelta(minutes=minutes if minutes > 0 else 30)
    dev = torch.device("cpu" if device is None else device)
    backend = backend_for(num_processes, torch.cuda.device_count()
                          if dev.type == "cuda" else 0, dev.type == "cuda")
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    if claim is not None and process_id == 0:
        # the coordinator's store binds this port next
        claim.close()
        claim = None
    attempts = max(int(bootstrap_retries), 1)
    try:
        for attempt in range(attempts):
            try:
                dist.init_process_group(
                    backend, init_method=f"tcp://{coordinator_address}",
                    world_size=int(num_processes), rank=int(process_id),
                    timeout=timeout)
                break
            except Exception as e:  # noqa: BLE001 — a bind or connect race
                if attempt + 1 >= attempts:
                    raise
                jitter = random.Random(
                    int(process_id) * 1_000_003 + attempt).random()
                delay = bootstrap_backoff_s * (2 ** attempt) * (1.0 + jitter)
                log_warning(f"cluster: bootstrap attempt {attempt + 1}/"
                            f"{attempts} failed ({type(e).__name__}: {e}); "
                            f"retrying in {delay:.2f}s")
                time.sleep(delay)
    finally:
        if claim is not None:
            claim.close()
    group = current_group()
    log_info(f"Cluster initialized: rank {group.rank} of {group.world} "
             f"({group.backend}, coordinator {coordinator_address})")
    return group


def make_mesh(num_shards: int = 0, group: Optional[Group] = None) -> Group:
    """The learners' group (JAX :211, a one-axis device mesh): every rank
    of ``group`` (default: ``current_group()``).  ``num_shards`` is its
    world size; 0 means all, and any other value raises, since a rank
    left out of the learner would be left idle."""
    g = group if group is not None else current_group()
    if num_shards not in (0, g.world):
        raise ValueError(
            f"num_shards={num_shards}: the parallel learners span every "
            f"rank of the group ({g.world}); set 0 or {g.world}, or start "
            f"{num_shards} ranks")
    return g


def shutdown() -> None:
    """Destroy the default group (a no-op when none is up)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
