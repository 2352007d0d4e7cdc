"""stage_s (s): the benchmark's clock around the first pass over every
variant of the cell's traffic, which stages and binds, ending in
``torch.cuda.synchronize()``."""


def read(obs):
    return obs.setup.get("stage_s")
