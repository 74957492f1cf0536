"""The multi-device layer (counterpart of parallel/mesh.py).

The reference's single-controller semantics, written out: one host thread
drives a list of devices (a ``Mesh``), the batch axis of a stage (cameras'
rays, query points, images, hypotheses, views) is split over them, and
every reduction is global and runs in a fixed order on the mesh's first
entry, its *home*, where state lives and optimizers step.  There is no
process group and no NCCL: work on each device is queued from the one
thread on that device's current stream, and cross-device copies are
ordered by PyTorch's stream events.

The reference annotates placements for XLA; here each becomes an explicit
call at the caller:

* ``batch_sharded`` / ``shard_leading`` / ``constrain(x, mesh, (DATA_AXIS,
  ...))`` -> ``shards`` / ``shard_leading``: the leading axis in one slice
  per entry (uneven where it does not divide), each on its entry's device;
* ``replicated`` / ``replicate`` -> ``replicate`` (a distinct copy of a
  module or tensors per entry, even where entries repeat a device, so no
  two shards write one ``.grad``) or ``broadcast`` (read-only tensors on
  each entry's device, shared where entries repeat one);
* the all-gather and ``psum`` XLA inserts -> ``gather`` (concatenation in
  entry order on home) and ``reduce_sum`` (0 + 1 + 2 + ... on home, so a
  sum is bit-reproducible); ``reduce_grads_`` / ``copy_params_`` apply
  them to a replicated module's grads and weights.

``cached_or_fresh`` is jit-cache plumbing and has no counterpart.  A mesh
may hold any devices, CPU entries or one card repeated included, which is
how the layer is tested without several cards.  An entry point called
without a mesh runs the same body on ``Mesh([device])`` whose one replica
is the caller's own state, not a copy: ``reduce_grads_`` and
``copy_params_`` then leave it as it is.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.device import resolve as resolve_device

DATA_AXIS = "data"


class Mesh:
    """A 1-D device mesh along ``DATA_AXIS``: a tuple of devices, entry 0
    the home device."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """A mesh over the first ``n_devices`` CUDA devices (all of them when
    None)."""
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise ValueError(f"make_mesh: {n} devices asked for, {count} CUDA devices present")
    return Mesh([torch.device("cuda", i) for i in range(n)])


def _index(dev: torch.device) -> int:
    if dev.index is not None:
        return dev.index
    return torch.cuda.current_device() if dev.type == "cuda" else 0


def same_device(a, b) -> bool:
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and _index(a) == _index(b)


def auto_mesh(min_devices: int = 2, device=None) -> Optional[Mesh]:
    """The entry points' default: a mesh over every CUDA device, ``device``
    (the card when None) first, or None unless ``device`` is a CUDA device
    and at least ``min_devices`` cards are present (so one card, or the
    CPU, runs exactly the unsharded path)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available() or torch.cuda.device_count() < min_devices:
        return None
    first = _index(dev)
    return Mesh([torch.device("cuda", i) for i in [first] + [i for i in range(torch.cuda.device_count())
                                                             if i != first]])


def resolve(mesh, device=None) -> Optional[Mesh]:
    """An entry point's ``mesh`` argument: "auto" is ``auto_mesh(device=
    device)``; a mesh whose home is not ``device`` (when one is named)
    raises."""
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f"mesh must be a Mesh, None or 'auto', got {mesh!r}")
        return auto_mesh(device=device)
    if mesh is not None and device is not None and not same_device(mesh.home, device):
        raise ValueError(f"the mesh's home device is {mesh.home}, the call names {device}")
    return mesh


def place(mesh, device=None):
    """(mesh, device) of an entry point that takes both: the mesh as
    ``resolve`` gives it, and ``device`` resolved (the card unless named),
    or the mesh's home when only a mesh is given."""
    mesh = resolve(mesh, device)
    if mesh is not None and device is None:
        return mesh, mesh.home
    return mesh, resolve_device(device)


def _map(fn, tree):
    """``fn`` on every tensor of a tree of tuples, named tuples, lists and
    dicts; other leaves are kept."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return tree


def slices(n: int, mesh: Mesh) -> list:
    """Entry i's slice of a leading axis of ``n``, as ``torch.tensor_split``
    cuts it: the first ``n % size`` entries take one more."""
    q, r = divmod(n, mesh.size)
    out, start = [], 0
    for i in range(mesh.size):
        stop = start + q + (i < r)
        out.append(slice(start, stop))
        start = stop
    return out


def shards(n: int, mesh: Mesh) -> list:
    """(entry, device, slice) of every entry whose slice of ``n`` is not
    empty, in entry order."""
    return [(i, d, s) for i, (d, s) in enumerate(zip(mesh.devices, slices(n, mesh))) if s.stop > s.start]


def shard_leading(tree, mesh: Mesh) -> list:
    """Entry i's slice of the leading axis of every tensor of ``tree``, on
    entry i's device: one tree per entry."""
    leads = []
    _map(lambda x: leads.append(x.shape[0]), tree)
    if len(set(leads)) > 1:
        raise ValueError(f"shard_leading: leading axes differ {sorted(set(leads))}")
    n = leads[0] if leads else 0
    return [part(tree, s, d) for d, s in zip(mesh.devices, slices(n, mesh))]


def replicate(obj, mesh: Mesh) -> list:
    """One distinct copy of a module, or of every tensor of a tree, on each
    entry's device."""
    if isinstance(obj, torch.nn.Module):
        return [copy.deepcopy(obj).to(d) for d in mesh.devices]
    return [_map(lambda x: x.detach().to(d, copy=True), obj) for d in mesh.devices]


def part(tree, s: slice, device):
    """The slice ``s`` of the leading axis of every tensor of ``tree``, on
    ``device``."""
    return _map(lambda x: x[s].to(device), tree)


def to(tree, device):
    """Every tensor of ``tree`` on ``device`` (not copied where it is)."""
    return _map(lambda x: x.to(device), tree)


def broadcast(tree, mesh: Mesh) -> list:
    """Every tensor of ``tree`` on each entry's device, for reading only
    (entries on one device share it)."""
    return [to(tree, d) for d in mesh.devices]


def gather(parts, mesh: Mesh, dim: int = 0):
    """The entries' trees concatenated along ``dim`` in entry order on
    home."""
    first = parts[0]
    flat = [[] for _ in parts]
    for j, part in enumerate(parts):
        _map(flat[j].append, part)
    out = iter([torch.cat([f[k].to(mesh.home) for f in flat], dim) for k in range(len(flat[0]))])
    return _map(lambda _: next(out), first)


def reduce_sum(parts, mesh: Mesh) -> torch.Tensor:
    """The sum of the entries' tensors on home, in entry order."""
    total = parts[0].to(mesh.home)
    for p in parts[1:]:
        total = total + p.to(mesh.home)
    return total


@torch.no_grad()
def reduce_grads_(params, replica_params) -> None:
    """Set each home parameter's ``.grad`` to the sum, in entry order, of
    its replicas' ``.grad`` (``replica_params``: one parameter list per
    entry, in ``params``' order; a lone replica that is the home parameter
    itself already holds it)."""
    home = params[0].device if params else None
    for k, p in enumerate(params):
        if len(replica_params) == 1 and replica_params[0][k] is p:
            continue
        parts = [r[k].grad for r in replica_params]
        total = parts[0].to(home, copy=True)
        for g in parts[1:]:
            total += g.to(home)
        p.grad = total


@torch.no_grad()
def copy_params_(params, replica_params) -> None:
    """Copy each home parameter's values into its replicas, in place (a
    replica that is the home parameter itself is left)."""
    for r in replica_params:
        for a, b in zip(r, params):
            if a is not b:
                a.copy_(b)


def pad_to_multiple(n: int, k: int) -> int:
    """Smallest multiple of k that is >= n."""
    return ((n + k - 1) // k) * k


def largest_divisor_mesh_size(batch: int, n_devices: int) -> int:
    """Largest d <= n_devices with batch % d == 0: the widest mesh a batch
    that does not divide the device count still splits evenly over."""
    for d in range(min(batch, n_devices), 0, -1):
        if batch % d == 0:
            return d
    return 1
