"""Native C++ components (Felzenszwalb superpixels, the SGR record reader),
built on first use and loaded through ctypes."""
