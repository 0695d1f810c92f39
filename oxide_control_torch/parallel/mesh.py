"""The env-axis mesh: one process per device, ``torch.distributed`` for
the collectives.

The port of ``oxide_control_tpu/parallel/mesh.py``.  The engine's scaling
axis is the environment batch.  Where the reference places a batch on a
``jax.sharding.Mesh`` and lets XLA insert the collectives, here every
rank of a process group holds its own contiguous rows ``[lo, hi)`` of the
batch on its own device, and the one collective of a rollout (the
consumer's mean return) is an explicit ``all_reduce``
(``parallel.rollout``).  Policy weights are replicated: every rank holds
the whole tensor.

``multihost_initialize`` brings the process group up (the analog of
``jax.distributed.initialize``); ``make_env_mesh`` describes this rank's
place in it; ``env_sharding`` and ``shard_env_state`` cut a batch;
``fold_in`` derives a rank's random stream from a shared generator.
``ENV_AXIS`` and ``replicated`` keep the reference's names for parity;
nothing in the port reads them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .. import default_device
from ..state import Data, tree_map

ENV_AXIS = "env"


@dataclasses.dataclass(frozen=True)
class EnvMesh:
    """This rank's place on a 1-D env mesh: its rank in ``group`` (0 ..
    ``world_size`` - 1), the group (None: the default group) and the device
    its rows live on."""

    rank: int
    world_size: int
    group: object
    device: torch.device

    def global_rank(self, rank: int) -> int:
        """The default group's rank of the mesh's ``rank``."""
        if self.group is None:
            return rank
        return dist.get_global_rank(self.group, rank)


# the process groups made by submesh, by their ranks in the default
# group, and the default group they belong to
_GROUPS: dict = {}
_GROUPS_WORLD = None


def _group(ranks: tuple[int, ...]):
    """The process group of the default group's ``ranks`` (None: the
    default group itself), made once for the life of the default group."""
    global _GROUPS_WORLD
    if _GROUPS_WORLD is not dist.group.WORLD:
        _GROUPS.clear()
        _GROUPS_WORLD = dist.group.WORLD
    if ranks == tuple(range(dist.get_world_size())):
        return None
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(list(ranks))
    return _GROUPS[ranks]


def submesh(ranks, device=None) -> EnvMesh | None:
    """The env mesh over the default group's ``ranks``, in their order;
    None on a rank outside them.  Every rank of the default group must
    call with the same ``ranks`` in the same order: the first call for a
    set of ranks makes its group (``new_group`` is collective) and later
    calls reuse it.  ``device`` defaults to the rank's card: CUDA device
    ``global rank % device_count``, and raises without one unless the
    caller passes ``device='cpu'``."""
    if not dist.is_initialized():
        raise RuntimeError("the process group is not initialized: call "
                           "parallel.mesh.multihost_initialize first")
    ranks = tuple(ranks)
    group = _group(ranks)
    me = dist.get_rank()
    if me not in ranks:
        return None
    if device is None:
        default_device()
        device = torch.device("cuda", me % torch.cuda.device_count())
    return EnvMesh(rank=ranks.index(me), world_size=len(ranks), group=group,
                   device=torch.device(device))


def make_env_mesh(n_devices: int | None = None,
                  device=None) -> EnvMesh | None:
    """The env mesh over every rank of the default group, or over its
    first ``n_devices`` ranks (:func:`submesh`: every rank must call, the
    ranks left out get None).  The process group must be up
    (:func:`multihost_initialize`)."""
    if not dist.is_initialized():
        raise RuntimeError("the process group is not initialized: call "
                           "parallel.mesh.multihost_initialize first")
    size = dist.get_world_size()
    if n_devices is None:
        n_devices = size
    if not 1 <= n_devices <= size:
        raise ValueError(f"n_devices {n_devices} not in [1, {size}]")
    return submesh(range(n_devices), device)


def env_sharding(mesh: EnvMesh, batch: int) -> tuple[int, int]:
    """This rank's rows ``[lo, hi)`` of a batch of ``batch`` envs: equal
    contiguous blocks in rank order.  A batch that the mesh does not
    divide is an error, as in the reference."""
    if batch % mesh.world_size:
        raise ValueError(f"a batch of {batch} envs does not divide over "
                         f"{mesh.world_size} ranks")
    per = batch // mesh.world_size
    return mesh.rank * per, (mesh.rank + 1) * per


def replicated(mesh: EnvMesh, x):
    """A replicated value: the identity on every rank.  Each rank holds
    the whole of ``x`` (the policy's weights, a scalar); nothing moves.
    The reference's ``P()`` placement."""
    return x


def shard_env_state(mesh: EnvMesh, data: Data) -> Data:
    """This rank's rows of a batched ``Data`` on the mesh's device: every
    field with an env axis keeps rows ``[lo, hi)``, a scalar stays
    whole."""
    lo, hi = env_sharding(mesh, data.qpos.shape[0])
    return tree_map(lambda x: (x[lo:hi] if x.dim() else x).to(mesh.device),
                    data)


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def _fold_in_seed(seed: int, index: int) -> int:
    """The 63-bit seed of stream ``index`` of ``seed`` (SplitMix64 of the
    two): the analog of ``jax.random.fold_in``."""
    return _splitmix64(_splitmix64(seed) ^ index) >> 1


def draw_seed(generator: torch.Generator) -> int:
    """One 62-bit draw of ``generator`` (on its device), read back."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device).item())


def fold_in(generator: torch.Generator, index: int,
            device=None) -> torch.Generator:
    """A new generator on ``device`` (default: the caller's) for stream
    ``index`` of ``generator``: seeded with SplitMix64 of the index and one
    draw of ``generator``.  Every rank whose generator is in the same
    state draws the same number, so the ranks agree on each rank's
    stream, and distinct indices give distinct streams."""
    seed = _fold_in_seed(draw_seed(generator), index)
    out = torch.Generator(device=device or generator.device)
    return out.manual_seed(seed)


def multihost_initialize(**kwargs) -> None:
    """Bring the process group up: ``torch.distributed.init_process_group``
    with ``kwargs`` (backend, init_method, rank, world_size, ...).

    The only failure passed over is a second call in a process whose
    group is already up (convenient in tests and notebooks); anything
    else (a bad address, a rank outside ``[0, world_size)``) raises: a
    silent no-op would masquerade as a single-process run."""
    if dist.is_initialized():
        return
    rank, world = kwargs.get("rank"), kwargs.get("world_size")
    if world is not None and world < 1:
        raise ValueError(f"world_size {world} < 1")
    if rank is not None and world is not None and not 0 <= rank < world:
        raise ValueError(f"rank {rank} not in [0, {world})")
    dist.init_process_group(**kwargs)


__all__ = ["EnvMesh", "env_sharding", "fold_in", "make_env_mesh",
           "multihost_initialize", "shard_env_state", "submesh"]
