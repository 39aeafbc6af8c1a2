"""Space-filling-curve helpers of the port: copies of the reference
package's `curve/` modules (host NumPy). Z2 and XZ2 key the partition
schemes, the time bins key the stats sketches and XZ's time dimension."""
