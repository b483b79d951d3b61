"""Models: PatchMatch, TSAR refinement, RANSAC, view selection."""
