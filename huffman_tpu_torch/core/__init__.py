"""Host-side table math (NumPy): canonical codes, package-merge, ILS layout."""
