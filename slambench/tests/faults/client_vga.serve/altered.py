from coxgraph_tpu_torch.mapper import submap_mapper as sm
_mesh = sm.HostMapper.live_mesh
def _bad(self, *a, **k):
    v, c = _mesh(self, *a, **k)
    return v + 0.01, c
sm.HostMapper.live_mesh = _bad
