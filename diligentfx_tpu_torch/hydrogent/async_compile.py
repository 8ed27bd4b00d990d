"""Async pipeline start with fallback execution (the port of the JAX
package's hydrogent/async_compile.py) — the analogue of the reference's
async shader compilation: HnRenderPass serves a FALLBACK PSO until the real
one is ready (EXECUTE_RESULT_FALLBACK, HnRenderPass interface:114-120) and
the task context suspends TAA supersampling while fallbacks are in flight
(HnRenderRprimsTask.cpp:154-156), resuming accumulation once the final
pipeline lands.

The port compiles no frame program; what the full pipeline needs before
its first frame is that frame itself: the kernel libraries it builds at
first use (nvcc, ops/cuda_build.py), the IBL and LUT tensors, the
allocator's first blocks.  A background thread renders that first frame
and synchronises the device; until it is done, frames are served by a
cheaper fallback configuration (fewer effects), with the loading overlay.
Then the full pipeline takes over from a fresh temporal state (the
HnTaskManager "suspend super-sampling" behaviour, HnTaskManager.hpp:248-252).
An error of the background frame is raised on the caller's thread.
"""
from __future__ import annotations

import dataclasses
import enum
import threading
import time
from typing import Optional

import torch

from diligentfx_tpu_torch.hydrogent.task_manager import (FrameSettings,
                                                         HnTaskManager,
                                                         TaskManagerCreateInfo)
from diligentfx_tpu_torch.postfx.tonemap import loading_animation


class ExecuteResult(enum.IntEnum):
    """EXECUTE_RESULT_* (HnRenderPass interface:114-120)."""
    OK = 0
    FALLBACK = 1      # frame rendered with the fallback pipeline
    SKIPPED = 2


def _fallback_ci(ci: TaskManagerCreateInfo) -> TaskManagerCreateInfo:
    """Cheap pipeline served while the real one starts: heavy stochastic
    effects off (they're also the ones that need temporal history, which the
    swap resets anyway); tone map + bloom keep the image presentable."""
    return dataclasses.replace(
        ci, enable_ssr=False, enable_ssao=False, enable_dof=False,
        enable_taa=False, enable_light_scattering=False)


class AsyncFramePipeline:
    """Wraps HnTaskManager: `execute` never blocks on the full pipeline's
    first frame; returns (FrameOutput, ExecuteResult)."""

    def __init__(self, renderer, ci: TaskManagerCreateInfo, *, width: int,
                 height: int, atlas=None,
                 settings: FrameSettings = FrameSettings(),
                 loading_overlay: bool = True):
        self.width, self.height = width, height
        self.settings = settings
        self.loading_overlay = loading_overlay
        self.full = HnTaskManager(renderer, ci, atlas=atlas)
        self.fallback = HnTaskManager(renderer, _fallback_ci(ci), atlas=atlas)
        self._ready = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._swapped = False
        # the background frame's seconds, once it is done
        self.background_seconds: Optional[float] = None

    # -- background start ------------------------------------------------------

    def start_compile(self, scene, info) -> None:
        """Start the full pipeline's first frame in a background thread
        (idempotent); the fallback frames proceed on the caller's thread."""
        if self._thread is not None:
            return

        def work():
            t0 = time.perf_counter()
            try:
                state = self.full.initial_state(self.width, self.height)
                out = self.full.execute(scene, info, state,
                                        width=self.width, height=self.height,
                                        settings=self.settings)
                if out.color.is_cuda:
                    torch.cuda.synchronize(out.color.device)
            except BaseException as e:   # raised on the caller's thread
                self._error = e
            finally:
                self.background_seconds = time.perf_counter() - t0
                self._ready.set()

        self._thread = threading.Thread(target=work, daemon=True,
                                        name="dfx-async-start")
        self._thread.start()

    @property
    def full_ready(self) -> bool:
        return self._ready.is_set() and self._error is None

    # -- frame execution -------------------------------------------------------

    def execute(self, scene, info, state=None):
        """Render one frame.  Uses the fallback pipeline until the full one
        has rendered its first frame; on the first full-quality frame the
        temporal state is re-initialized (TAA supersampling resumes from
        scratch)."""
        if self._error is not None:
            raise self._error
        if self._thread is None:
            self.start_compile(scene, info)
        if self.full_ready:
            if not self._swapped or state is None:
                state = self.full.initial_state(self.width, self.height)
                self._swapped = True
            out = self.full.execute(scene, info, state, width=self.width,
                                    height=self.height,
                                    settings=self.settings)
            return out, ExecuteResult.OK
        if state is None or self._swapped:
            # (re-)enter fallback (e.g. first frames): fallback state shape
            self._swapped = False
            state = self.fallback.initial_state(self.width, self.height)
        out = self.fallback.execute(scene, info, state, width=self.width,
                                    height=self.height,
                                    settings=self.settings)
        if self.loading_overlay:
            # subtle streaming indicator (GetLoadingAnimationColor analogue)
            t = out.state.frame_index / 30.0
            out = out._replace(color=loading_animation(out.color, 0.15, t))
        return out, ExecuteResult.FALLBACK
