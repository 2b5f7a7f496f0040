"""Core WASI math: the rank policy, CholeskyQR (``orthogonal``) and the
factored-mode WSI refresh (``wsi``). The Tucker/ASI math, project mode and
PowerSGD arrive with later slices."""
