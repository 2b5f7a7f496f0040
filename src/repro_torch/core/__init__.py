"""Core WASI math. This slice ports the rank policy only; the Tucker/WSI
math arrives with the training slice."""
