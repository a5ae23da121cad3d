"""roofline_pct.mega_paths: percent of its roofline of the RGB render
megakernel (`csrc/mega_paths.cu`, device kernel `mega_paths_kernel`) in
the frames cells (`roofline.launch_roofline_pct`)."""
from rmbench.roofline import launch_roofline_pct


def read(run):
    return launch_roofline_pct(run, "mega_paths_kernel")
