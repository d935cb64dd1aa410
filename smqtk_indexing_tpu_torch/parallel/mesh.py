"""
Device mesh and row-sharding helpers of the port.

Counterpart of ``smqtk_indexing_tpu/parallel/mesh.py``. The JAX mesh is
single-controller: one call fans out over every shard inside
``shard_map``. The port keeps that model in one process. A :class:`Mesh`
is a list of torch devices shaped ``(S,)`` with the axis ``"shard"``, or
``(dcn, S / dcn)`` with the axes ``("dcn", "shard")``, enumerated
slice-major as the JAX mesh is. A sharded tensor is a list of S tensors,
shard ``s`` on the mesh's ``s``-th device (slice-major); a replicated one
is a list of S tensors holding the same values, one tensor per distinct
device. Each shard runs the port's single-device function on its own
tensors (``parallel/sharded_*.py``), so a CUDA shard runs the kernels and
a CPU shard their plain versions, by where its tensors lie.

Devices come from the index classes' ``device`` argument with
``n_devices = n`` (:func:`mesh_for`):

- ``"cuda"``: cards ``cuda:0`` .. ``cuda:n-1``;
- ``"cpu"``: n shards on the CPU (the counterpart of JAX's virtual host
  devices; the tests run so);
- a list of n device strings: each shard placed explicitly, the same card
  possibly more than once (the counterpart of ``make_mesh(devices=)``).

Unlike the JAX ``make_mesh`` (``mesh.py:36-54``), which builds the mesh on
the CPU host platform when the default backend has too few devices,
:func:`make_mesh` never moves to another device: too few cards raise.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from smqtk_indexing_tpu_torch.ops.device import resolve_device

SHARD_AXIS = "shard"
DCN_AXIS = "dcn"

#: A sharded or replicated tensor: one tensor a shard, slice-major.
Shards = List[torch.Tensor]


class Mesh:
    """
    Devices of a single-process mesh.

    :param devices: object array of ``torch.device``, shaped ``(S,)`` or
        ``(dcn, S / dcn)``.
    :param axis_names: ``("shard",)`` or ``("dcn", "shard")``.
    """

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"devices of shape {devices.shape} for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        """Axis name -> size."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def flat(self) -> List[torch.device]:
        """Every shard's device, slice-major (global shard order)."""
        return list(self.devices.flat)

    @property
    def first(self) -> torch.device:
        """The device the merged results land on."""
        return self.flat[0]

    def slices(self) -> List[List[int]]:
        """Global shard indices of each slice ("dcn" position), in order;
        one slice on a 1-D mesh."""
        per = self.shape[SHARD_AXIS]
        return [list(range(i * per, (i + 1) * per))
                for i in range(self.size // per)]

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.flat]}, "
                f"shape={self.shape})")


def _cuda_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None, dcn: int = 1,
              device: str = "cuda") -> Mesh:
    """
    Build a mesh over ``n_devices`` devices: 1-D ``("shard",)`` when
    ``dcn == 1``, else 2-D ``("dcn", "shard")`` with ``dcn`` slices of
    ``n_devices // dcn`` devices, assigned slice-major.

    :param n_devices: shard count, a power of two (default: every visible
        card, or one CPU shard).
    :param devices: explicit devices, one a shard (a card may repeat);
        ``n_devices``, when given, takes the first ``n_devices`` of them.
    :param device: ``"cuda"`` (cards ``cuda:0`` ..) or ``"cpu"`` (every
        shard on the CPU), used when ``devices`` is None.
    :raises ValueError: more shards than visible cards, a count that is
        not a power of two, or a ``dcn`` that does not divide it.
    :raises RuntimeError: a CUDA device without a card.
    """
    if devices is None:
        kind = torch.device(device).type
        if kind == "cpu":
            devices = [torch.device("cpu")] * (n_devices or 1)
        elif kind == "cuda":
            resolve_device("cuda")
            devices = [torch.device("cuda", i) for i in range(_cuda_count())]
        else:
            raise ValueError(f"unsupported device {device!r}")
    else:
        devices = [resolve_device(d) for d in devices]
        for d in devices:
            if d.type == "cuda":
                index = 0 if d.index is None else d.index
                if index >= _cuda_count():
                    raise ValueError(
                        f"device {str(d)!r} requested; {_cuda_count()} "
                        "card(s) visible.")
        devices = [torch.device("cuda", d.index or 0)
                   if d.type == "cuda" else d for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"Requested {n_devices} devices; only {len(devices)} "
                "available (visible cards: "
                f"{_cuda_count()}).")
        devices = devices[:n_devices]
    count = len(devices)
    if count < 1 or count & (count - 1):
        raise ValueError(
            f"n_devices must be a power of two (got {count}): store "
            "capacities are 1024*2^m and must shard evenly.")
    arr = np.empty(count, dtype=object)
    arr[:] = devices
    if dcn > 1:
        if count % dcn:
            raise ValueError(
                f"dcn={dcn} does not divide device count {count}.")
        return Mesh(arr.reshape(dcn, count // dcn), (DCN_AXIS, SHARD_AXIS))
    return Mesh(arr, (SHARD_AXIS,))


def mesh_for(n_devices: Optional[int],
             device: Union[str, Sequence[str]]) -> Optional[Mesh]:
    """
    The mesh of an index class's ``n_devices`` and ``device`` arguments,
    or None for one device: ``n_devices`` None or 1, whatever form
    ``device`` takes (a one-device list only names the primary device),
    as the JAX ``_make_mesh`` returns None for ``n_devices <= 1``.

    :raises ValueError: a device list whose length is not ``n_devices``
        (1 when ``n_devices`` is None).
    """
    if isinstance(device, (list, tuple)) and len(device) != (n_devices or 1):
        raise ValueError(
            f"a device list of {len(device)} places {len(device)} shards; "
            f"got n_devices={n_devices}")
    if n_devices is None or n_devices <= 1:
        return None
    if isinstance(device, (list, tuple)):
        return make_mesh(n_devices, devices=device)
    return make_mesh(n_devices, device=device)


def primary_device(device: Union[str, Sequence[str]]) -> torch.device:
    """The device of an index's single-device state: ``device`` itself,
    or the first of a device list."""
    if isinstance(device, (list, tuple)):
        return resolve_device(device[0])
    return resolve_device(device)


def device_config(device: Union[str, Sequence[str]]):
    """``device`` as ``get_config`` stores it: a device list stays a list
    of strings, one device its string."""
    if isinstance(device, (list, tuple)):
        return [str(resolve_device(d)) for d in device]
    return str(resolve_device(device))


def row_axes(mesh: Mesh) -> tuple:
    """Mesh axis names that the row dimension shards over (all of them)."""
    return tuple(mesh.axis_names)


def _place(part: torch.Tensor, dev: torch.device, src_dev,
           distinct: bool) -> torch.Tensor:
    out = part.to(dev)
    if distinct and out.device == src_dev:
        # A view would keep the whole source alive on this device.
        out = out.clone()
    return out


def shard_rows(mesh: Mesh, arr, axis: int = 0) -> Shards:
    """
    Split ``arr`` (numpy or torch) into ``mesh.size`` equal blocks along
    ``axis`` and place block ``s`` on shard ``s``'s device. A numpy array
    goes from host memory straight to each shard's device; the whole
    array is never staged on one device.

    :raises ValueError: the axis length does not divide by the mesh size.
    """
    n_dev = mesh.size
    length = arr.shape[axis]
    if length % n_dev:
        raise ValueError(
            f"Dim {axis} of length {length} not divisible by mesh size "
            f"{n_dev}.")
    per = length // n_dev
    distinct = len(set(mesh.flat)) > 1
    out = []
    for s, dev in enumerate(mesh.flat):
        if isinstance(arr, np.ndarray):
            part = np.ascontiguousarray(
                np.take(arr, np.arange(s * per, (s + 1) * per), axis=axis)
                if axis else arr[s * per:(s + 1) * per])
            out.append(torch.from_numpy(part).to(dev))
        else:
            part = arr.narrow(axis, s * per, per)
            out.append(_place(part, dev, arr.device, distinct))
    return out


def replicate(mesh: Mesh, arr) -> Shards:
    """One copy of ``arr`` (numpy or torch) on each distinct device of the
    mesh, listed a shard; shards sharing a device share the tensor. A list
    that is already one a shard passes through."""
    if isinstance(arr, list):
        if len(arr) != mesh.size:
            raise ValueError(f"{len(arr)} shards for a mesh of {mesh.size}")
        return arr
    if isinstance(arr, np.ndarray):
        arr = torch.from_numpy(np.ascontiguousarray(arr))
    copies = {}
    out = []
    for dev in mesh.flat:
        if dev not in copies:
            copies[dev] = arr.to(dev)
        out.append(copies[dev])
    return out
