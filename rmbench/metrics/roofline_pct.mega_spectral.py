"""roofline_pct.mega_spectral: percent of its roofline of the spectral
render megakernel (`csrc/mega_spectral.cu`, device kernel
`mega_spectral_kernel`) in the frames cells
(`roofline.launch_roofline_pct`)."""
from rmbench.roofline import launch_roofline_pct


def read(run):
    return launch_roofline_pct(run, "mega_spectral_kernel")
