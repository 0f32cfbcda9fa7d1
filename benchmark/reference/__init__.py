"""The plain reference of the try-on path and of the training step: a
frozen copy of the port's plain code (host prep, device conditioning, the
gather warps, input assembly, the generator; the discriminators, the
losses, ADA and the training step's phases) in PyTorch and NumPy, with
F.conv2d where the port launches K1, the plain row shift where it
launches K2 and K3, and PIL / cv2 where it may use its C++ plugin. It
imports nothing of the port and nothing of JAX; `tryon.py` and
`train/steps.py` are its entries.
"""
