"""VOT evaluation: the TraX server and the VOT entry."""
