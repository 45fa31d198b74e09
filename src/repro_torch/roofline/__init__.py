from repro_torch.roofline.analysis import (  # noqa: F401
    HW, roofline_terms)
