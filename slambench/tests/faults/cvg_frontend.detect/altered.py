from coxgraph_tpu_torch.ops import features as ft
_detect = ft.detect_and_describe_batch
def _bad(*a, **k):
    kp = _detect(*a, **k)
    return kp._replace(desc=kp.desc ^ 1)
ft.detect_and_describe_batch = _bad
