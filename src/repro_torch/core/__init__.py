"""Core WASI math: the rank policy, CholeskyQR (``orthogonal``), the
factored-mode WSI refresh (``wsi``), the Tucker/ASI compression of saved
activations (``asi``) and the custom-gradient matmuls that train from it
(``lowrank_linear``). Project mode and PowerSGD arrive with later slices."""
