"""Histogram merging across ranges and samples (``distributed.merge_histograms``)."""
