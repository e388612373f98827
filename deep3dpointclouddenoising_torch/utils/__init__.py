"""Host-side helpers: device selection and spatial indexes."""
