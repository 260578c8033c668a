"""coxgraph_tpu_torch — the PyTorch/CUDA port of coxgraph_tpu.

The JAX package ``coxgraph_tpu`` stays the reference; this package mirrors
its module paths and function names so each counterpart is easy to find,
and runs on an NVIDIA Hopper GPU. It imports ``torch`` and never ``jax``.

Ported so far (the per-robot integration slice and loop detection):

core      : SE(3) geometry (``core.geometry``), block-sparse voxel pools
            and allocation (``core.voxel``)
frontends : the analytic synthetic RGB-D renderer (``frontends.synthetic``)
            and the multi-robot keyframe database and loop detector
            (``frontends.loop_detector``)
solver    : the relative-pose and height constraint pools
            (``solver.pose_graph``; the LM solve is not ported yet)
ops       : projective TSDF integration (``ops.tsdf``) and its CUDA block
            update kernel (``ops.cuda_tsdf``); Harris/BRIEF features,
            matching and RANSAC (``ops.features``) and the CUDA Hamming
            matcher (``ops.cuda_hamming``); kernel sources in ``csrc/``
mapper    : ``MapperState``, ``integrate_batch`` and ``HostMapper.step_batch``
server    : the ``MapFusionMsg`` the detector emits (``server.fusion_server``;
            the server itself is not ported yet)
eval      : the TSDF integration benchmark and the loop-detection
            operating point (``eval.benchmarks``)
utils     : state interop with the JAX package (``utils.interop``)

Every function takes its tensors on an explicit device; there is no global
default device. The entry points (``HostMapper``, ``LoopDetector``) build
their state on the card unless they are given another device. Functions that the JAX package wrote as pure functions over
donated buffers update the port's pools IN PLACE and say so.
"""

__version__ = "0.1.0"
