from coxgraph_tpu_torch.mapper import submap_mapper as sm
_step = sm.HostMapper.step
def _half(self, depth, color, T, t):
    self._n = getattr(self, "_n", 0) + 1
    return _step(self, depth, color, T, t) if self._n % 2 else False
sm.HostMapper.step = _half
