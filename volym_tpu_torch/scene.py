"""Scene: the render inputs as tensors on one device.

Counterpart of :mod:`volym_tpu.scene`.  Besides the float32 volume, a scene
built from uint8 data keeps the uint8 grid itself (``volume_u8``): the u8
march streams it directly, 1 byte a voxel, instead of re-rounding the float
copy every frame, but only while the copy is current
(:meth:`Scene.current_volume_u8`); otherwise the march derives the grid
from ``volume``, as the JAX package does on every frame.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import numpy as np
import torch

from volym_tpu_torch import assets
from volym_tpu_torch.transfer_function import TransferFunction


@dataclass
class Scene:
    """Render inputs.

    Attributes:
      volume:     (D, H, W) float32 densities in [0, 1].
      importance: (D, H, W) float32 in [0, 1].
      tf_lut:     (N, 4) float32 RGBA LUT.
      volume_u8:  (D, H, W) uint8 with ``volume == volume_u8 / 255``, or
                  ``None`` when the volume is not u8-representable.
      u8_source:  which ``volume`` tensor, at which ``_version``, the
                  ``volume_u8`` copy was made from (:func:`u8_record`), or
                  ``None``.  Set by :meth:`from_uint8`, by
                  :func:`volym_tpu_torch.convert.scene` and by :meth:`to`;
                  a scene made any other way (``dataclasses.replace``
                  included) has no record for its own volume.
    """

    volume: torch.Tensor
    importance: torch.Tensor
    tf_lut: torch.Tensor
    volume_u8: torch.Tensor | None = None
    u8_source: tuple | None = field(default=None, repr=False, compare=False)

    def current_volume_u8(self) -> torch.Tensor | None:
        """``volume_u8`` while it is the copy of ``volume`` as it stands:
        the record names these two tensors at their present ``_version``
        (an in-place edit of either bumps it).  ``None`` otherwise."""
        if self.volume_u8 is None or self.u8_source is None:
            return None
        vol_ref, vol_version, u8_ref, u8_version = self.u8_source
        current = (
            vol_ref() is self.volume and u8_ref() is self.volume_u8
            and vol_version == self.volume._version and u8_version == self.volume_u8._version
        )
        return self.volume_u8 if current else None

    def to(self, device) -> "Scene":
        current = self.current_volume_u8() is not None
        volume = self.volume.to(device)
        volume_u8 = None if self.volume_u8 is None else self.volume_u8.to(device)
        return Scene(
            volume=volume,
            importance=self.importance.to(device),
            tf_lut=self.tf_lut.to(device),
            volume_u8=volume_u8,
            u8_source=u8_record(volume, volume_u8) if current else None,
        )

    @property
    def device(self) -> torch.device:
        return self.volume.device

    @classmethod
    def from_uint8(
        cls,
        volume_u8: np.ndarray,
        importance_u8: np.ndarray | None = None,
        tf: TransferFunction | None = None,
        device="cpu",
    ) -> "Scene":
        vol = assets.normalize_volume(volume_u8)
        imp = (
            assets.normalize_volume(importance_u8)
            if importance_u8 is not None
            else np.zeros_like(vol)
        )
        lut = (tf or TransferFunction.default()).build_lut()
        volume = torch.as_tensor(vol, device=device)
        grid = torch.as_tensor(np.ascontiguousarray(volume_u8, np.uint8), device=device)
        return cls(
            volume=volume,
            importance=torch.as_tensor(imp, device=device),
            tf_lut=torch.as_tensor(lut, device=device),
            volume_u8=grid,
            u8_source=u8_record(volume, grid),
        )

    @classmethod
    def load(
        cls,
        volume_path,
        segments_raw_path=None,
        segments_json_path=None,
        flip: bool = True,
        side: int = assets.VOLUME_SIDE,
        tf: TransferFunction | None = None,
        device="cpu",
    ) -> "Scene":
        vol = assets.load_raw_volume(volume_path, flip=flip, side=side)
        imp = None
        if segments_raw_path is not None and segments_json_path is not None:
            imp, _hist = assets.load_importance_volume(
                segments_raw_path, segments_json_path, flip=flip, side=side
            )
        return cls.from_uint8(vol, imp, tf, device=device)

    @classmethod
    def synthetic(cls, kind: str = "bonsai", side: int = 256, seed: int = 0, device="cpu") -> "Scene":
        if kind == "bonsai":
            return cls.from_uint8(assets.synthetic_bonsai(side, seed), device=device)
        if kind == "sphere":
            return cls.from_uint8(assets.synthetic_sphere(side), device=device)
        if kind == "teapot":
            vol, labels, infos = assets.synthetic_teapot_segments(side)
            imp = assets.map_segments_to_importance(labels, infos)
            return cls.from_uint8(vol, imp, device=device)
        raise ValueError(f"unknown synthetic scene kind: {kind}")


def u8_record(volume: torch.Tensor, volume_u8: torch.Tensor) -> tuple:
    """The record that ``volume_u8`` is the uint8 copy of ``volume`` as the
    two stand now: weak references to both tensors (a freed tensor never
    matches a new one) and their ``_version`` counters."""
    return weakref.ref(volume), volume._version, weakref.ref(volume_u8), volume_u8._version
