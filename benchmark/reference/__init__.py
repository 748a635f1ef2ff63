"""The plain reference of the benchmark: the scene and its renderer, the
camera paths, the camera model, the FAST segment test, the trajectory
alignment, the roofline arithmetic and the comparison that decides
``correct``. Plain PyTorch and NumPy; it imports neither jax nor either
package of the system under test."""
