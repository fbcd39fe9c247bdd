# Execution policy of the padded fused scans (see costmodel.py).  The
# module is not imported here, so that ``python -m
# repro_torch.roofline.costmodel`` runs it as its only copy.
