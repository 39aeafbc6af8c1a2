"""Space-filling-curve helpers of the port: time binning."""
