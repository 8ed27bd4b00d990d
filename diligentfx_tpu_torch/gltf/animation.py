"""glTF animation and skinning evaluation on the host (the port's own copy
of diligentfx_tpu/gltf/animation.py; numpy only, and bit-equal to it).

The loader keeps each model's animation channels (parse_animations).
`AnimationPlayer.evaluate(t)` samples them (STEP, LINEAR with slerp for
rotations, CUBICSPLINE) into per-node local TRS matrices and returns the
world matrices of the node hierarchy; `compute_skin_matrices` folds them
with a skin's inverse-bind matrices into the world-space joint matrices
gltf/model.py update_animation uploads each frame (the analogue of
WriteSkinningData, PBR_Renderer.cpp:2595, and HnSkinningComputation's
double-buffered current / previous transforms).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from diligentfx_tpu_torch.gltf.loader import GLTFModel, GLTFNode


@dataclass
class AnimationChannel:
    node: int
    path: str                 # translation | rotation | scale | weights
    times: np.ndarray         # (N,)
    values: np.ndarray        # (N, C)
    interpolation: str = "LINEAR"


@dataclass
class Animation:
    name: str = ""
    channels: List[AnimationChannel] = field(default_factory=list)

    @property
    def duration(self) -> float:
        return max((float(c.times[-1]) for c in self.channels if len(c.times)),
                   default=0.0)


def parse_animations(doc: dict, reader) -> List[Animation]:
    """Parse the `animations` array (called from loader.parse_gltf)."""
    out = []
    for a in doc.get("animations", []):
        anim = Animation(name=a.get("name", ""))
        samplers = a.get("samplers", [])
        for ch in a.get("channels", []):
            smp = samplers[ch["sampler"]]
            target = ch.get("target", {})
            node = target.get("node", -1)
            if node < 0:
                continue
            times = reader.accessor(smp["input"]).reshape(-1).astype(np.float32)
            values = reader.accessor(smp["output"]).astype(np.float32)
            interp = smp.get("interpolation", "LINEAR")
            if interp == "CUBICSPLINE":
                # glTF spec: output has 3 elements per keyframe —
                # (in-tangent, value, out-tangent) — reshape to (N, 3, C).
                values = values.reshape(len(times), 3, -1)
            anim.channels.append(AnimationChannel(
                node=node, path=target.get("path", "translation"),
                times=times, values=values, interpolation=interp))
        out.append(anim)
    return out


def _slerp(q0, q1, t):
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    th = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)


def _sample(ch: AnimationChannel, t: float) -> np.ndarray:
    times = ch.times
    n = len(times)
    if n == 0:
        return None
    cubic = ch.interpolation == "CUBICSPLINE"     # values: (N, 3, C)
    if t <= times[0]:
        v = ch.values[0, 1] if cubic else ch.values[0]
    elif t >= times[-1]:
        v = ch.values[-1, 1] if cubic else ch.values[-1]
    else:
        i = int(np.searchsorted(times, t) - 1)
        d = max(float(times[i + 1] - times[i]), 1e-9)
        f = (t - times[i]) / d
        if ch.interpolation == "STEP":
            v = ch.values[i]
        elif cubic:
            # Cubic Hermite on (value_k, out-tangent_k, in-tangent_{k+1},
            # value_{k+1}); glTF spec eq. for CUBICSPLINE samplers.
            v0 = ch.values[i, 1]
            b0 = ch.values[i, 2]          # out-tangent of key i
            a1 = ch.values[i + 1, 0]      # in-tangent of key i+1
            v1 = ch.values[i + 1, 1]
            f2, f3 = f * f, f * f * f
            v = ((2 * f3 - 3 * f2 + 1) * v0 + d * (f3 - 2 * f2 + f) * b0
                 + (-2 * f3 + 3 * f2) * v1 + d * (f3 - f2) * a1)
            if ch.path == "rotation":
                v = v / max(np.linalg.norm(v), 1e-9)
        elif ch.path == "rotation":
            v = _slerp(ch.values[i], ch.values[i + 1], f)
        else:
            v = ch.values[i] + f * (ch.values[i + 1] - ch.values[i])
    return v


class AnimationPlayer:
    """Evaluates animations onto a GLTFModel's node hierarchy."""

    def __init__(self, model: GLTFModel, animations: List[Animation]):
        self.model = model
        self.animations = animations
        # per-node base TRS
        self._base: Dict[int, dict] = {}

    def evaluate(self, t: float, animation_index: int = 0, loop: bool = True
                 ) -> List[np.ndarray]:
        """Returns per-node world matrices at time t (seconds)."""
        model = self.model
        locals_ = [n.local.copy() for n in model.nodes]
        if self.animations:
            anim = self.animations[animation_index % len(self.animations)]
            dur = anim.duration
            if loop and dur > 0:
                t = t % dur
            trs: Dict[int, dict] = {}
            for ch in anim.channels:
                v = _sample(ch, t)
                if v is None:
                    continue
                trs.setdefault(ch.node, {})[ch.path] = v
            for ni, parts in trs.items():
                node = {"translation": parts.get("translation"),
                        "rotation": parts.get("rotation"),
                        "scale": parts.get("scale")}
                locals_[ni] = _trs_to_matrix(model.nodes[ni], node)
        # world pass (row-vector: world = local @ parent_world)
        worlds: List[Optional[np.ndarray]] = [None] * len(model.nodes)

        def world_of(i):
            if worlds[i] is not None:
                return worlds[i]
            p = model.nodes[i].parent
            w = locals_[i] if p < 0 else locals_[i] @ world_of(p)
            worlds[i] = w
            return w

        for i in range(len(model.nodes)):
            world_of(i)
        return worlds


def _trs_to_matrix(node: GLTFNode, overrides: dict) -> np.ndarray:
    # decompose base local if a component is missing: approximate by using the
    # original local matrix when nothing overrides; otherwise compose TRS with
    # overrides falling back to identity components extracted cheaply.
    t = overrides.get("translation")
    r = overrides.get("rotation")
    s = overrides.get("scale")
    base = node.local
    if t is None:
        t = base[3, :3]
    if s is None:
        s = np.linalg.norm(base[:3, :3], axis=1)
    if r is None:
        m = base[:3, :3] / np.maximum(s[:, None], 1e-9)
        r = _matrix_to_quat(m)
    x, y, z, w = r
    rot = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y + z * w), 2 * (x * z - y * w), 0],
        [2 * (x * y - z * w), 1 - 2 * (x * x + z * z), 2 * (y * z + x * w), 0],
        [2 * (x * z + y * w), 2 * (y * z - x * w), 1 - 2 * (x * x + y * y), 0],
        [0, 0, 0, 1]], np.float32)
    sm = np.diag([s[0], s[1], s[2], 1.0]).astype(np.float32)
    tm = np.eye(4, dtype=np.float32)
    tm[3, :3] = t
    return sm @ rot @ tm


def _matrix_to_quat(m: np.ndarray) -> np.ndarray:
    """Row-vector rotation matrix → quaternion (x, y, z, w)."""
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (m[1, 2] - m[2, 1]) / s
        y = (m[2, 0] - m[0, 2]) / s
        z = (m[0, 1] - m[1, 0]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[1, 2] - m[2, 1]) / s
        x = 0.25 * s
        y = (m[1, 0] + m[0, 1]) / s
        z = (m[2, 0] + m[0, 2]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[2, 0] - m[0, 2]) / s
        x = (m[1, 0] + m[0, 1]) / s
        y = 0.25 * s
        z = (m[2, 1] + m[1, 2]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[0, 1] - m[1, 0]) / s
        x = (m[2, 0] + m[0, 2]) / s
        y = (m[2, 1] + m[1, 2]) / s
        z = 0.25 * s
    q = np.array([x, y, z, w], np.float32)
    return q / np.linalg.norm(q)


def compute_skin_matrices(model: GLTFModel, skin_index: int,
                          node_worlds: List[np.ndarray]) -> np.ndarray:
    """(J, 4, 4) world-space skin matrices = inverseBind @ jointWorld
    (row-vector order: p_skinned = p @ ibm @ world)."""
    skin = model.skins[skin_index]
    joints = skin["joints"]
    ibm = skin["inverse_bind_matrices"]
    out = np.zeros((len(joints), 4, 4), np.float32)
    for i, j in enumerate(joints):
        m = ibm[i] if ibm is not None else np.eye(4, dtype=np.float32)
        out[i] = m @ node_worlds[j]
    return out
