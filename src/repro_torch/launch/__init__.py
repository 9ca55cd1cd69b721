"""Step functions, the serving and training CLIs, and the roofline
tools (model FLOPs, the step analysis, the roofline terms) of the port."""
