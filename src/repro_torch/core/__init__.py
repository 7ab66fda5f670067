"""FetchSGD core: Count Sketch, layout, top-k, optimizer, accounting."""
