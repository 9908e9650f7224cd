"""The benchmark's own counts of each kernel's and model's work, frozen so a
later kernel is measured against the same work (each input read once, each
output written once; the least time is the larger of bytes over the HBM
rate and operations over the peak of the precision the products use)."""
