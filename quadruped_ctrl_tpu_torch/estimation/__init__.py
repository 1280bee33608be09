"""State estimation: orientation and the linear Kalman filter."""
