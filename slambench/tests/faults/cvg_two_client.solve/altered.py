from coxgraph_tpu_torch.server import global_opt, fusion_server as fs
_solve = global_opt.optimize_two_phase
def _bad(*a, **k):
    poses, info = _solve(*a, **k)
    poses = poses.clone()
    poses[:, 4] += 0.05
    return poses, info
fs.global_opt.optimize_two_phase = _bad
