"""build_s (s): the benchmark's clock around the port's
``segment_from_arrays`` calls."""


def read(obs):
    return obs.setup.get("build_s")
