from coxgraph_tpu_torch.frontends import loop_detector as ld
ld.LoopDetector.add_keyframes_batch = lambda self, items, generator=None: []
