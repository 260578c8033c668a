import dataclasses
from coxgraph_tpu_torch.server import global_opt, fusion_server as fs
_solve = global_opt.optimize_two_phase
def _half(poses, constraints, *a, **k):
    valid = constraints.valid.clone()
    valid[1::2] = False
    return _solve(poses, dataclasses.replace(constraints, valid=valid),
                  *a, **k)
fs.global_opt.optimize_two_phase = _half
