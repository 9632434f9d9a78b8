"""Plain references of the solver, outside both packages."""
