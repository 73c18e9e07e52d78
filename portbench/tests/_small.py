"""A cell cut to a size the CPU tests can hold: the configuration's frame
cut to `size`, tiles of 16x16 and 8 samples a chunk, at most 6 samples a
pixel.  Only the tests cut a cell so."""

from harness import bench


def small_cell(workload: str, size=(48, 27), spp_max: int = 6, root: str = bench.ROOT):
    spec = bench.Spec(root)
    cell = spec.cell(workload)
    data = spec.config(cell["config"])
    data["size"] = list(size)
    traffic = dict(spec.traffic(cell["traffic"]), tile=16, launch_rays=16 * 16 * 8,
                   trace_tiles=2)
    traffic["spp"] = min(traffic["spp"], spp_max)
    return spec, data, traffic, spec.limits(workload)
