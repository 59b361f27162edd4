"""K2: the dense-slot frame renderer, as hand-written CUDA
(``csrc/megakernel_dense.cu``, on the kernels of ``csrc/megakernel.cuh``
that it shares with K1) beside its plain PyTorch version.

Replaces ``adanerf_tpu/ops/pallas/megakernel.py::make_megakernel``, the JAX
viewer's ``--megakernel v3``: K1's front half, then the NeRF at every one
of a ray's S slots, dead slots masked in the composite. It suits frames
whose rays sit at the sample cap, where compaction saves nothing.
``MegakernelDense(renderer)`` packs the renderer's two MLPs once, in K1's
layout; calling it renders a batch of rays to ``(rgb (B, 3), counts (B,))``:

  * on a CUDA tensor it launches the kernel (three launches on the current
    stream, no host synchronisation) and counts the call in ``launches``;
  * on a CPU tensor it runs the plain version, ``plain``: the renderer's
    dense path (``RealtimeRenderer._dense_shade_stage``).

Besides K1's limits, the wrapper refuses what the TPU kernel computes
differently from the pipeline it stands in for, as that kernel refuses NDC:
it hard-codes the InverseSqrtDistCentered normalization, applies only the
``alpha`` accumulation premultiply, and always applies the depth transform
(no ``*NoDepthRange`` sampler).
"""

from __future__ import annotations

from .megakernel_compact import MegakernelCompact

SOURCE = "megakernel_dense.cu"


class MegakernelDense(MegakernelCompact):
    """K2 wrapper around a ``RealtimeRenderer`` (the plain version).

    ``MegakernelDense.launches`` counts kernel launches over all instances,
    apart from K1's count."""

    launches = 0
    SOURCE, SYMBOL = SOURCE, "mk_dense_launch"
    DENSE = True

    def __init__(self, renderer):
        if renderer.use_ndc:
            raise ValueError("the dense-slot kernel does not implement the NDC ray "
                             "transform (megakernel.py:294-296); use the compacted "
                             "kernel (MegakernelCompact)")
        if renderer.norm_name != "InverseSqrtDistCentered":
            raise ValueError("the dense-slot kernel implements rayMarchNormalization[1] "
                             f"'InverseSqrtDistCentered' only; got {renderer.norm_name!r}")
        if renderer.accumulation_mult == "weights":
            raise ValueError("the dense-slot kernel applies accumulationMult 'alpha' only; "
                             "got 'weights'")
        if renderer.z_no_range:
            raise ValueError("the dense-slot kernel always applies the depth transform; "
                             "a *NoDepthRange sampler is not implemented")
        super().__init__(renderer)

    def plain(self, dirs, pose, rot):
        """The plain PyTorch version: the renderer's dense path."""
        return self.renderer.render_rays(pose, rot, dirs, compaction=False)
