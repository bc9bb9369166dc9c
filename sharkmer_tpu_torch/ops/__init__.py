"""Device-side compute ops: encoding, the key codec, the sorted count
store, histograms and primer scans."""
