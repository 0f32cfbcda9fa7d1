"""Traffic mixes: one JSON file of parameters a mix (`<name>.json`),
read by the one generator in `synth.py`."""
