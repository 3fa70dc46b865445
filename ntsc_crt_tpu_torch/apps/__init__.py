"""Front ends: the live session and its terminal and X11 windows."""
