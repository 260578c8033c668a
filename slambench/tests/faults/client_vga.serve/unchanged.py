from coxgraph_tpu_torch.mapper import submap_mapper as sm
sm.HostMapper.step = lambda self, *a, **k: False
