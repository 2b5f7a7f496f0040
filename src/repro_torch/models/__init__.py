"""Models (port of repro.models): the dense decoder LM."""
