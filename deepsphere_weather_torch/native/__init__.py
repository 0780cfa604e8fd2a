"""Optional native libraries, loaded through ctypes on first use."""
