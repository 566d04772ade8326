"""NumPy/OpenCV oracle: loop-faithful reimplementations of the reference
C++ nodes (sangbeom0321/Active-orchard-slam), the parity target of the
tensor pipeline. A copy of ``aosx/oracle`` (every ``aosx`` module imports
jax through the package's ``__init__``); it reads no tensor, so it stays in
NumPy. OpenCV is imported only inside the functions that call it."""
