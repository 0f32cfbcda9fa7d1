"""The plain reference of the try-on path: a frozen copy of the port's
plain code (host prep, device conditioning, the gather warps, input
assembly, the generator) in PyTorch and NumPy, with F.conv2d where the
port launches K1 and PIL / cv2 where it may use its C++ plugin. It
imports nothing of the port and nothing of JAX; `tryon.py` is its entry.
"""
