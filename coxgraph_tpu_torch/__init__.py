"""coxgraph_tpu_torch — the PyTorch/CUDA port of coxgraph_tpu.

The JAX package ``coxgraph_tpu`` stays the reference; this package mirrors
its module paths and function names so each counterpart is easy to find,
and runs on an NVIDIA Hopper GPU. It imports ``torch`` and never ``jax``.

Ported so far (integration, loop detection, serving, the solve, the
collaborative server tier and the parallel tier):

core      : SE(3) geometry (``core.geometry``), block-sparse voxel pools,
            allocation and sampling (``core.voxel``)
frontends : the analytic synthetic RGB-D renderer and drifting odometry
            (``frontends.synthetic``), the multi-robot keyframe database
            and loop detector (``frontends.loop_detector``) and the VIO
            facade (``frontends.vio_interface``)
solver    : the relative-pose and height constraint pools and the LM
            pose-graph solve (``solver.pose_graph``)
ops       : projective TSDF integration (``ops.tsdf``) and its CUDA block
            update kernel (``ops.cuda_tsdf``); Harris/BRIEF features,
            matching and RANSAC (``ops.features``) and the CUDA Hamming
            matcher (``ops.cuda_hamming``); meshing, ESDF and layer merge
            (``ops.mesh``, ``ops.mesh_incremental``, ``ops.esdf``,
            ``ops.merge``); dense TSDF registration
            (``ops.registration``); the mesh post-process
            (``ops.mesh_post``); kernel sources in ``csrc/``
mapper    : ``MapperState``, ``integrate_batch``, ``HostMapper.step_batch``,
            live meshing, the local pose graph, ``trajectory`` and the
            merged-map server (``mapper.map_server``)
server    : the fusion server and its client interface
            (``server.fusion_server``, ``server.client_interface``) and the
            two-phase global optimize (``server.global_opt``)
eval      : the benchmarks (``eval.benchmarks``), the two-robot demo
            (``eval.demos``), ATE/RPE (``eval.metrics``) and PLY/TUM
            export (``eval.export``)
parallel  : the multi-robot tier on torch.distributed — SPMD fleet
            integration and the distributed pose-graph solve
            (``parallel.fleet``), the slab-sharded ESDF
            (``parallel.esdf_sharded``), the sharded merge and mesh
            (``parallel.merge_sharded``), multi-process bring-up
            (``parallel.multihost``); the dry run (``eval.dryrun``)
utils     : state interop with the JAX package (``utils.interop``)

Every function takes its tensors on an explicit device; there is no global
default device. The entry points (``HostMapper``, ``LoopDetector``,
``CoxgraphServer``, ``TwoRobotDemo``) build their state on the card unless
they are given another device. Functions that the JAX package wrote as
pure functions over donated buffers update the port's pools IN PLACE and
say so.
"""

__version__ = "0.1.0"
