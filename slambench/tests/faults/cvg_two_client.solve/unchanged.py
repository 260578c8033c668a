from coxgraph_tpu_torch.server import fusion_server as fs
fs.CoxgraphServer.optimize = lambda self, push_updates=True: {}
