"""The benchmark's plain reference: `frame.py` computes a configuration's
frame with the frozen plain copy in `dfx/`; `compare.py` holds the port's
frames against it."""
