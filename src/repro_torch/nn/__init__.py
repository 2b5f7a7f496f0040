"""Neural-net layers (port of repro.nn): plain functions on tensors, with
parameters in the reference's dict layout."""
