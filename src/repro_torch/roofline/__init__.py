# The padded fused scans' schedule constants and the roofline's device
# peaks (costmodel.py), and the dry run's roofline analysis (analysis.py).
