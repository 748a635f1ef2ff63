"""Map save and load.

Port of the JAX package's ``utils/serialization.py``: the whole SLAMMap
(points, keyframes with their pyramids and SBIs, the measurement table)
and the configuration in one compressed ``.npz``, under the same key names
(``map.points.pos_w``, ``map.keyframes.pyramid.0``, ...), the same
``__config__`` JSON and the same ``__version__``, so a map saved by either
package loads in the other. ``export_map_text`` writes the reference's
debug dump (GUICommandHandler("SaveMap"), jni/MapMaker.cc:1254-1286).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from visualslam_android_tpu_torch.config import SLAMConfig
from visualslam_android_tpu_torch.models import map_store
from visualslam_android_tpu_torch.utils.tensors import default_device

_FORMAT_VERSION = 1


def _flatten(prefix, obj, out):
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            _flatten(f"{prefix}{f.name}.", getattr(obj, f.name), out)
    elif isinstance(obj, tuple):
        for i, val in enumerate(obj):
            _flatten(f"{prefix}{i}.", val, out)
    else:
        out[prefix.rstrip(".")] = obj.detach().cpu().numpy()


def save_map(path, slam_map: map_store.SLAMMap, config: SLAMConfig):
    """Writes the map and its configuration to `path` (.npz)."""
    arrays = {}
    _flatten("map.", slam_map, arrays)
    arrays["__config__"] = np.frombuffer(config.to_json().encode(),
                                         dtype=np.uint8)
    arrays["__version__"] = np.asarray(_FORMAT_VERSION)
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def load_map(path, device=None):
    """(slam_map on `device`, the CUDA card when None; config). Every
    array must have the shape and dtype the configuration's empty map
    has."""
    device = default_device(device)
    data = np.load(path)
    version = int(data["__version__"])
    if version != _FORMAT_VERSION:
        raise ValueError(f"unsupported map format version {version}")
    config = SLAMConfig.from_json(bytes(data["__config__"]).decode())
    empty = map_store.empty_map(config, device="cpu")

    def rebuild(prefix, template):
        if dataclasses.is_dataclass(template):
            return dataclasses.replace(template, **{
                f.name: rebuild(f"{prefix}{f.name}.",
                                getattr(template, f.name))
                for f in dataclasses.fields(template)})
        if isinstance(template, tuple):
            return tuple(rebuild(f"{prefix}{i}.", v)
                         for i, v in enumerate(template))
        key = prefix.rstrip(".")
        arr = torch.from_numpy(np.array(data[key]))
        if arr.shape != template.shape or arr.dtype != template.dtype:
            raise ValueError(
                f"{key}: {tuple(arr.shape)} {arr.dtype} in the file, "
                f"{tuple(template.shape)} {template.dtype} expected")
        return arr.to(device)

    return rebuild("map.", empty), config


def export_map_text(out_dir, slam_map: map_store.SLAMMap):
    """The reference's text export: ``map.dump``, one line per live map
    point (world position, then source level), and
    ``keyframes/<i>.info``, each valid keyframe's 3x4 [R|t]
    camera-from-world pose. A debug format; save_map is the checkpoint."""
    os.makedirs(os.path.join(out_dir, "keyframes"), exist_ok=True)
    pts = slam_map.points
    live = pts.live().cpu().numpy()
    pos = pts.pos_w.cpu().numpy()
    lvl = pts.source_level.cpu().numpy()
    with open(os.path.join(out_dir, "map.dump"), "w") as f:
        for i in np.nonzero(live)[0]:
            f.write(f"{pos[i, 0]:.9g} {pos[i, 1]:.9g} {pos[i, 2]:.9g}  "
                    f"{int(lvl[i])}\n")
    kfs = slam_map.keyframes
    R, t = kfs.R.cpu().numpy(), kfs.t.cpu().numpy()
    for i in np.nonzero(kfs.valid.cpu().numpy())[0]:
        with open(os.path.join(out_dir, "keyframes", f"{i}.info"), "w") as f:
            for r in range(3):
                f.write(f"{R[i, r, 0]:.9g} {R[i, r, 1]:.9g} "
                        f"{R[i, r, 2]:.9g} {t[i, r]:.9g}\n")
