"""Native host libraries, loaded through ctypes on first use: the C++
conservative-remap overlaps (`geometry`) and the bulk zarr chunk reader
(`chunkio`), built with g++ at first use (`build`), and the system
libblosc (`bloscio`)."""
