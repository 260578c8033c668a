from coxgraph_tpu_torch.ops import cuda_tsdf, tsdf
_upd = cuda_tsdf.update_blocks
def _bad(spec, cfg, intr, layers, k, slots, mask, *a):
    _upd(spec, cfg, intr, layers, k, slots, mask, *a)
    rows = (k.long() * spec.max_blocks + slots.long())[mask]
    layers.sdf.view(-1, layers.sdf.shape[-1])[rows] += 0.01
tsdf.cuda_tsdf.update_blocks = _bad
