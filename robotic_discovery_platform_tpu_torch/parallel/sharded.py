"""The U-Net's forward over a mesh's "model" and "spatial" axes, installed
on its modules as hooks (``models/unet.py``: each module's ``shard``,
and ``GroupNorm.sync``), as ``parallel/dp.sync_batch_norm`` installs
``BatchNorm.sync``. With no hook the single-device forward runs
unchanged. Every hooked conv is the plain one (``ops/conv.conv3x3_plain``),
as the JAX trainer trains under a mesh.

- ``model``: a conv whose kernel ``parallel/mesh.tp_param_specs`` splits
  holds its ``Cout / model`` slice as its ``kernel`` parameter, convolves
  with it and gathers the channels over the model group
  (``collectives.gather_channels``); its input's gradient is summed over
  the group (``collectives.grad_sum_over``), since each rank's backward
  gives only its channels' share. The transposed conv of a non-bilinear
  ``Up`` likewise, its bias added after the gather.
- ``spatial``: a rank holds row block ``s`` of each map. A 3x3 conv pads
  H with one halo row from each neighbour (``collectives.halo_rows``) and
  convolves with padding 0 in H and 1 in W. GroupNorm's per-sample means
  are averaged over the spatial group; BatchNorm's over the data x
  spatial group (``dp.py``). ``Up`` takes its target size from the skip,
  whose H is the shard's: it gathers the deeper map's rows, upsamples on
  the global map's grid (the align-corners matrix of the global sizes)
  and keeps this rank's rows.

The rule for levels whose H does not split (H = 32 over 4 ranks reaches a
map 2 rows high): a map is row-split while every pool above it found an
even local H. A pool whose local input H is odd gathers the input whole
on the spatial group (``collectives.gather_rows``, whose backward is the
reduce-scatter) and pools it whole; every rank of the group then holds
the same whole map, and the levels below stay whole, with plain padding
and no GroupNorm sync. The decoder's ``Up`` at a split level splits the
map again into row blocks: it keeps this rank's rows, whose gradient
(zero elsewhere) the gather's reduce-scatter sums back. So level ``k``
is split iff ``spatial > 1`` and the input's local H is divisible by
``2**k`` (:meth:`Layout.split`).
"""

from __future__ import annotations

import torch

from robotic_discovery_platform_tpu_torch.models.unet import (
    Conv3x3,
    ConvTranspose2x2,
    Down,
    GroupNorm,
    UNet,
    Up,
    max_pool2x2,
    resize_nearest,
    upsample_align_corners,
)
from robotic_discovery_platform_tpu_torch.ops.conv import (
    conv3x3_plain,
    conv_transpose2x2_plain,
)
from robotic_discovery_platform_tpu_torch.parallel import collectives


class Layout:
    """One mesh's view of a forward: the rank's groups, the spatial
    axis's size, and the local H of the input being run (set by
    ``UNet.forward`` through :meth:`begin`)."""

    def __init__(self, groups, spatial: int):
        self.groups, self.spatial = groups, spatial
        self.h0 = None

    def begin(self, x: torch.Tensor) -> None:
        self.h0 = x.shape[1]

    def split(self, level: int) -> bool:
        """Whether the maps of U-Net level ``level`` (0: the input's
        size, 4: the deepest) are row-split over the spatial group."""
        return self.spatial > 1 and self.h0 % (1 << level) == 0


class _Conv:
    """A 3x3 conv at ``level``, its kernel split over "model" (``tp``)."""

    def __init__(self, layout: Layout, level: int, tp: bool):
        self.layout, self.level, self.tp = layout, level, tp

    def __call__(self, conv: Conv3x3, x: torch.Tensor) -> torch.Tensor:
        groups = self.layout.groups
        if self.tp:
            x = collectives.grad_sum_over(x, groups.model)
        if self.layout.split(self.level):
            y = conv3x3_plain(collectives.halo_rows(x, groups.spatial),
                              conv.kernel, padding=(0, 1))
        else:
            y = conv3x3_plain(x, conv.kernel)
        return collectives.gather_channels(y, groups.model) if self.tp else y


class _ConvT:
    """A non-bilinear ``Up``'s transposed conv, its kernel split over
    "model"."""

    def __init__(self, layout: Layout):
        self.layout = layout

    def __call__(self, convt: ConvTranspose2x2, x: torch.Tensor
                 ) -> torch.Tensor:
        model = self.layout.groups.model
        y = conv_transpose2x2_plain(collectives.grad_sum_over(x, model),
                                    convt.kernel)
        return collectives.gather_channels(y, model) + convt.bias.to(x.dtype)


class _Pool:
    """The max-pool into ``level``."""

    def __init__(self, layout: Layout, level: int):
        self.layout, self.level = layout, level

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.layout.split(self.level - 1) and not self.layout.split(
                self.level):
            x = collectives.gather_rows(x, self.layout.groups.spatial)
        return max_pool2x2(x)


class _Upsample:
    """An ``Up`` into ``level``: the deeper map upsampled to the skip's
    global size, this rank's rows kept where the level is split."""

    def __init__(self, layout: Layout, level: int):
        self.layout, self.level = layout, level

    def __call__(self, up: Up, x: torch.Tensor, skip: torch.Tensor,
                 cache: dict | None) -> torch.Tensor:
        layout, spatial = self.layout, self.layout.groups.spatial
        if layout.split(self.level + 1):
            x = collectives.gather_rows(x, spatial)
        rows, w = skip.shape[1], skip.shape[2]
        split = layout.split(self.level)
        h = rows * layout.spatial if split else rows
        if up.bilinear:
            x = upsample_align_corners(x, h, w, cache)
        else:
            x = resize_nearest(up.ConvTranspose_0(x), h, w, cache)
        if split:
            x = x.narrow(1, layout.groups.coord[1] * rows, rows)
        return x


class _GroupStats:
    """GroupNorm's per-sample statistics at ``level``: averaged over the
    spatial group where the level is split."""

    def __init__(self, layout: Layout, level: int):
        self.layout, self.level = layout, level

    def __call__(self, mean: torch.Tensor, sq: torch.Tensor):
        if not self.layout.split(self.level):
            return mean, sq
        spatial = self.layout.groups.spatial
        stats = collectives.sum_over(torch.stack([mean, sq]), spatial) / (
            collectives.size(spatial))
        return stats[0], stats[1]


def _level(name: str) -> int:
    """The U-Net level of a top-level submodule's outputs:
    ``DoubleConv_0`` and the head 0, ``Down_i`` i + 1, ``Up_i`` 3 - i."""
    kind, _, i = name.partition("_")
    if kind == "Down":
        return int(i) + 1
    if kind == "Up":
        return 3 - int(i)
    return 0


def install(net: UNet, groups, spatial: int, tp_names=()) -> None:
    """Hook ``net``'s modules for a mesh of ``spatial`` rows blocks and
    the kernels ``tp_names`` (parameter names) split over "model";
    ``groups`` is ``mesh.mesh_groups``'s. A module with nothing split
    keeps its own forward: ``install(net, groups, 1)`` puts back the
    single-device forward (BatchNorm's ``sync`` apart:
    ``dp.sync_batch_norm``)."""
    layout = Layout(groups, spatial)
    split = spatial > 1
    tp_names = set(tp_names)
    net.shard = layout if split else None
    for name, module in net.named_modules():
        level = _level(name.partition(".")[0])
        if isinstance(module, Conv3x3):
            tp = f"{name}.kernel" in tp_names
            module.shard = _Conv(layout, level, tp) if split or tp else None
        elif isinstance(module, ConvTranspose2x2):
            module.shard = (_ConvT(layout) if f"{name}.kernel" in tp_names
                            else None)
        elif isinstance(module, Down):
            module.shard = _Pool(layout, level) if split else None
        elif isinstance(module, Up):
            module.shard = _Upsample(layout, level) if split else None
        elif isinstance(module, GroupNorm):
            module.sync = _GroupStats(layout, level) if split else None

