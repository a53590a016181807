"""Report helpers of the port's performance tooling
(:mod:`repro_torch.roofline.report_utils`)."""
