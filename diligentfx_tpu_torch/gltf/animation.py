"""glTF animation data (the port's own copy of the parsing half of
diligentfx_tpu/gltf/animation.py; numpy only).

The loader keeps each model's animation channels.  Evaluating them
(AnimationPlayer, skin matrices, gltf/model.py update_animation) comes with
skinning and animation, ROADMAP.md §1 item 5.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np


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
