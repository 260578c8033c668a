from coxgraph_tpu_torch.mapper import submap_mapper as sm
sm.HostMapper.step_batch = lambda self, d, c, T, ts: 0
