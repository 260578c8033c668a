from coxgraph_tpu_torch.mapper import submap_mapper as sm
_step = sm.HostMapper.step_batch
def _half(self, d, c, T, ts):
    n = len(ts) // 2
    return _step(self, d[:n], c[:n], T[:n], ts[:n])
sm.HostMapper.step_batch = _half
