"""Model text and the binning constants the serving path reads."""
