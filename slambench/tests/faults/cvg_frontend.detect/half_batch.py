from coxgraph_tpu_torch.frontends import loop_detector as ld
_add = ld.LoopDetector.add_keyframes_batch
def _half(self, items, generator=None):
    return _add(self, items[:len(items) // 2], generator)
ld.LoopDetector.add_keyframes_batch = _half
